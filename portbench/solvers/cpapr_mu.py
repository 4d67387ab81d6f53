"""The ``cpapr_mu`` traffic: whole CP-APR MU solves through the port's
public entry, and the comparison of each with the plain reference.

A traffic file that names ``"solver": "cpapr_mu"`` gives the solve's
parameters: ``rank``, ``strategy``, ``max_outer``, ``max_inner``, ``tol``
(the other ``CPAPRConfig`` fields keep their defaults) and
``warmup_outer``, the sweeps of the set-up's warm-up solve.
"""
from __future__ import annotations

import torch

from ..reference import cpapr_mu as plain

__all__ = ["compare", "program_inputs", "reference", "solve"]

def _config(traffic: dict, max_outer: int):
    from repro_torch.core.cpapr import CPAPRConfig

    return CPAPRConfig(rank=int(traffic["rank"]), strategy=traffic["strategy"],
                       max_outer=int(max_outer),
                       max_inner=int(traffic["max_inner"]),
                       tol=float(traffic["tol"]))


def program_inputs(problem: dict) -> tuple:
    """The port's ``(SparseTensor, KTensor)`` over the benchmark's tensors."""
    from repro_torch.core.sparse_tensor import KTensor, SparseTensor

    t = SparseTensor(tuple(problem["dims"]), problem["indices"],
                     problem["values"])
    init = KTensor(problem["lam0"], tuple(problem["factors0"]))
    return t, init


def solve(inputs: tuple, traffic: dict, device, warmup: bool = False) -> dict:
    """One whole solve; returns what the window counts and the judge reads.
    ``warmup`` runs the set-up's short solve instead."""
    from repro_torch.core.cpapr import cpapr_mu

    t, init = inputs
    outer = traffic["warmup_outer"] if warmup else traffic["max_outer"]
    res = cpapr_mu(t, int(traffic["rank"]), init=init,
                   config=_config(traffic, outer), device=device)
    return {"program_s": float(res.seconds), "sweeps": int(res.n_outer),
            "inner_iters": int(sum(res.inner_iters)),
            "lam": res.ktensor.lam, "factors": list(res.ktensor.factors)}


def reference(problem: dict, traffic: dict, control: bool = False) -> dict:
    """The plain reference's solve from the same tensor and start
    (``control``: computed as TF32 matrix units would)."""
    return plain.cpapr_mu(problem["indices"], problem["values"],
                          problem["lam0"], problem["factors0"],
                          max_outer=int(traffic["max_outer"]),
                          max_inner=int(traffic["max_inner"]),
                          tol=float(traffic["tol"]), control=control)


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.to(x.device).double()
    scale = float(torch.linalg.vector_norm(ref))
    return float(torch.linalg.vector_norm(x - ref)) / max(scale, 1e-300)


def compare(answer: dict, ref: dict) -> dict:
    """The compared numbers of one solve against the reference's, each
    held to a limit in the cell file:

    * ``lam_rel``: |lam - lam_ref| / |lam_ref| of the fitted weights;
    * ``factor_rel``: the largest over the modes of |A - A_ref|_F /
      |A_ref|_F of the fitted factor matrices.

    The log-likelihood history is not compared: a float32 sum over the
    nonzeros departs from the exact one by as much as the TF32 control's
    whole solve does (see PERF.md), so no limit could tell them apart.
    """
    return {
        "lam_rel": _rel(answer["lam"], ref["lam"]),
        "factor_rel": max(_rel(a, r) for a, r in zip(answer["factors"],
                                                     ref["factors"])),
    }
