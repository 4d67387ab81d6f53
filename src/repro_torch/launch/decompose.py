"""Decompose a FROSTT-shaped tensor with CP-APR MU on one device.

  PYTHONPATH=src python -m repro_torch.launch.decompose --tensor uber \\
      --scale 1.0 --rank 16
  PYTHONPATH=src python -m repro_torch.launch.decompose --tensor uber \\
      --scale 0.001 --rank 4 --strategy segment --device cpu

Synthesizes the tensor from ``--seed``, draws the starting model from the
same seed, runs ``cpapr_mu`` and prints the KKT and log-likelihood
histories (the log-likelihood must not decrease) and the seconds per
sweep.
"""
from __future__ import annotations

import argparse

from ..core.cpapr import CPAPRConfig, CPAPRResult, cpapr_mu, poisson_loglik
from ..core.policy import PhiPolicy
from ..data.tensors import TENSOR_NAMES, make_tensor
from ..device import resolve_device

__all__ = ["decompose", "main"]


def decompose(tensor: str = "uber", scale: float = 1.0, rank: int = 16,
              seed: int = 0, strategy: str = "cuda", max_outer: int = 5,
              max_inner: int = 10, policy: PhiPolicy | None = None,
              device="cuda") -> tuple:
    """Make ``tensor`` at ``scale`` and solve it.

    Returns ``(SparseTensor, ground-truth KTensor, CPAPRResult)``.
    """
    dev = resolve_device(device)
    t, truth = make_tensor(tensor, scale=scale, rank=rank, seed=seed,
                           device=dev)
    cfg = CPAPRConfig(rank=rank, max_outer=max_outer, max_inner=max_inner,
                      strategy=strategy, policy=policy)
    res = cpapr_mu(t, rank, seed=seed, config=cfg, device=dev)
    return t, truth, res


def report(name: str, t, truth, res: CPAPRResult) -> None:
    print(f"{name}: shape {t.shape}, nnz={t.nnz}")
    print("KKT history:", [f"{h:.4g}" for h in res.kkt_history])
    print("inner iterations:", res.inner_iters)
    print("loglik:", [f"{x:.6g}" for x in res.loglik_history])
    print("seconds per sweep:", [f"{s:.3f}" for s in res.sweep_seconds])
    ll_truth = float(poisson_loglik(t, truth.normalize()))
    print(f"ground-truth model loglik {ll_truth:.6g}; converged "
          f"{res.converged} after {res.n_outer} sweeps, {res.seconds:.3f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber", choices=TENSOR_NAMES)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="cuda",
                    choices=("cuda", "blocked", "segment", "scatter"))
    ap.add_argument("--max-outer", type=int, default=5)
    ap.add_argument("--max-inner", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t, truth, res = decompose(args.tensor, args.scale, args.rank, args.seed,
                              args.strategy, args.max_outer, args.max_inner,
                              device=args.device)
    report(args.tensor, t, truth, res)


if __name__ == "__main__":
    main()
