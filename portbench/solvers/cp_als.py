"""The ``cp_als`` traffic: whole CP-ALS solves through the port's public
entry, and the comparison of each with the plain reference.

A traffic file that names ``"solver": "cp_als"`` gives the solve's
parameters: ``rank``, ``strategy`` and ``n_iters`` (``cp_als``'s other
arguments keep their defaults: validation on, the fit returned) and
``warmup_iters``, the iterations of the set-up's warm-up solve.  Every
solve of the window starts from the same tensor and start, passed as
``init`` (its weights folded into the first factor, as ``cp_als`` does),
and runs ``n_iters`` iterations: there is no stopping rule.  A sweep is
one ALS iteration, every mode updated once (the Khatri-Rao gather and
layout expansion, MTTKRP, the Gram product and its ridge solve) and the
fit evaluated once, so ``sweep_s`` is seconds per iteration with the
solve's own preparation (validation, sorts, layouts) inside the call
counted in.

The window's solves are compared with one solve of
``reference/cp_als.py`` (float64, plain PyTorch) from the same tensor and
start (:func:`compare`).  The fit history is returned but not compared:
on these tensors the fit is ~1.7e-4 (|X - M| / |X| ~ 0.99983), and a
float32 fit resolves to one float32 ulp of 1.0, ~6e-8, so its history
holds no more than a few ulps of information about the model.
"""
from __future__ import annotations

import torch

from ..reference import cp_als as plain
from . import cpapr_mu as mu

__all__ = ["compare", "program_inputs", "reference", "solve"]

#: the port's ``(SparseTensor, KTensor)`` over the benchmark's tensors
program_inputs = mu.program_inputs


def solve(inputs: tuple, traffic: dict, device, warmup: bool = False) -> dict:
    """One whole solve; returns what the window counts and the judge reads.
    ``warmup`` runs the set-up's short solve instead."""
    from repro_torch.core.cpals import cp_als

    t, init = inputs
    iters = int(traffic["warmup_iters"] if warmup else traffic["n_iters"])
    kt, fits = cp_als(t, int(traffic["rank"]), n_iters=iters,
                      strategy=traffic["strategy"], init=init, device=device)
    return {"sweeps": iters, "lam": kt.lam, "factors": list(kt.factors),
            "fits": list(fits)}


def reference(problem: dict, traffic: dict, control: bool = False) -> dict:
    """The plain reference's solve from the same tensor and start
    (``control``: computed as TF32 matrix units would), with the nonzeros'
    indices that :func:`compare` evaluates the models at."""
    ref = plain.cp_als(problem["indices"], problem["values"], problem["lam0"],
                       problem["factors0"], n_iters=int(traffic["n_iters"]),
                       control=control)
    ref["indices"] = problem["indices"]
    return ref


def compare(answer: dict, ref: dict) -> dict:
    """The compared numbers of one solve against the reference's, each
    held to a limit in the cell file:

    * ``lam_rel``: |lam - lam_ref| / |lam_ref| of the fitted weights;
    * ``factor_rel``: the largest over the modes of |A - A_ref|_F /
      |A_ref|_F of the fitted factor matrices (unit column sums);
    * ``model_rel``: |m - m_ref| / |m_ref| of the fitted models' values at
      the stored nonzeros, in float64; it does not depend on how the
      scale is split between the weights and the columns.

    The fit history is not compared (see the module's docstring).
    """
    m = plain.model_values(ref["indices"], answer["lam"], answer["factors"])
    m_ref = plain.model_values(ref["indices"], ref["lam"], ref["factors"])
    return {
        "lam_rel": mu._rel(answer["lam"], ref["lam"]),
        "factor_rel": max(mu._rel(a, r) for a, r in zip(answer["factors"],
                                                        ref["factors"])),
        "model_rel": mu._rel(m, m_ref),
    }
