"""Quickstart on the PyTorch port: decompose a sparse count tensor with
CP-APR MU (the paper's algorithm) on the card and inspect the fit.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core import (
    CPAPRConfig,
    cpapr_mu,
    poisson_loglik,
    random_poisson_tensor,
)
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. synthesize a sparse Poisson tensor from a planted rank-4 model
    tensor, truth = random_poisson_tensor(0, (200, 150, 120), nnz=30_000,
                                          rank=4, device=dev)
    print(f"tensor {tensor.shape}, nnz={tensor.nnz} "
          f"(density {tensor.density():.2e})")

    # 2. fit CP-APR MU (paper Alg. 1); Phi strategy = the hand-written Φ
    #    kernels ('cuda') on the card, the sorted segmented reduce
    #    ('segment', the CPU's best) on the CPU
    strategy = "cuda" if dev.type == "cuda" else "segment"
    print(f"Phi strategy: {strategy}")
    result = cpapr_mu(tensor, rank=4,
                      config=CPAPRConfig(rank=4, max_outer=10,
                                         strategy=strategy),
                      device=dev)

    print(f"outer iterations: {result.n_outer}  converged: {result.converged}")
    print("log-likelihood trajectory:",
          [f"{x:.0f}" for x in result.loglik_history])
    ll_truth = float(poisson_loglik(tensor, truth.normalize()))
    print(f"fitted loglik {result.loglik_history[-1]:.0f} vs "
          f"ground-truth model {ll_truth:.0f}")

    # 3. factors are non-negative and column-normalized
    for n, f in enumerate(result.ktensor.factors):
        print(f"mode {n}: factor {tuple(f.shape)}, min={float(f.min()):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
