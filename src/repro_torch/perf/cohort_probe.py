"""Run-to-run spread of the bucket tier's solves on the card.

``batched_cpapr_mu`` reduces Φ for a whole bucket with one ``index_add_``,
whose float atomics add in an order that changes from run to run on the
card.  This probe solves the on-card test's jobs (three rank-3 jobs of
shape (17, 11, 9) with 500 nonzeros, seeds 20-22, starting models from
seeds 100-102, 12 sweeps at tol 1e-3) ``--batched-repeats`` times as a
3-job bucket and each job alone through the same bucket ``--repeats``
times, and prints one JSON line: per job, the largest relative factor
difference between two alone runs (the card's own noise), the largest
between a batched run and an alone run, and whether every run's sweep
and inner counts are equal.

A relative difference here is the smallest ``rtol`` with which
``np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL)`` passes:
``max((|a - b| - ATOL) / |b|)`` over the factor and λ entries.

  PYTHONPATH=src python -m repro_torch.perf.cohort_probe --repeats 12
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["JOBS", "ATOL", "job_tensors", "rel_spread", "run_probe"]

ATOL = 1e-6  # the on-card test's absolute tolerance
JOBS = 3
RANK = 3
SHAPE, NNZ = (17, 11, 9), 500
SEEDS, INIT_SEEDS = (20, 21, 22), (100, 101, 102)
CFG = dict(max_outer=12, tol=1e-3, track_loglik=False)


def job_tensors() -> list:
    """The on-card test's three jobs, on the CPU."""
    from ..core.sparse_tensor import random_poisson_tensor

    return [random_poisson_tensor(SHAPE, nnz=NNZ, rank=RANK, seed=s,
                                  device="cpu")[0] for s in SEEDS]


def rel_spread(a, b) -> float:
    """The smallest rtol at which ``a`` and ``b`` agree with atol ATOL
    (0 when they agree within ATOL alone)."""
    a, b = a.float().cpu(), b.float().cpu()
    excess = ((a - b).abs() - ATOL).clamp_min(0.0)
    return float((excess / b.abs().clamp_min(1e-30)).max())


def _result_spread(r1, r2) -> float:
    parts = [rel_spread(r1.ktensor.lam, r2.ktensor.lam)]
    parts += [rel_spread(x, y) for x, y in zip(r1.ktensor.factors,
                                                r2.ktensor.factors)]
    return max(parts)


def run_probe(repeats: int, batched_repeats: int = 3,
              device="cuda") -> dict:
    """Solve the jobs as one bucket ``batched_repeats`` times and each
    job alone through that bucket ``repeats`` times; per job, the
    largest spread between two alone runs and between a batched run and
    an alone run."""
    from ..core.cpapr import CPAPRConfig
    from ..serve.batch import batched_cpapr_mu

    ts = job_tensors()
    cfg = CPAPRConfig(rank=RANK, **CFG)
    batched, bucket = [], None
    for _ in range(batched_repeats):
        res, bucket = batched_cpapr_mu(ts, RANK, seeds=list(INIT_SEEDS),
                                       config=cfg, bucket=bucket,
                                       device=device)
        batched.append(res)
    jobs = []
    for j in range(JOBS):
        alone = [batched_cpapr_mu([ts[j]], RANK, seeds=[INIT_SEEDS[j]],
                                  config=cfg, bucket=bucket,
                                  device=device)[0][0]
                 for _ in range(repeats)]
        mine = [b[j] for b in batched]
        counts = {(r.n_outer, tuple(r.inner_iters)) for r in alone + mine}
        jobs.append({
            "job": j,
            "alone_vs_alone": max(
                _result_spread(a, b) for i, a in enumerate(alone)
                for b in alone[i + 1:]),
            "batched_vs_alone": max(_result_spread(b, a) for b in mine
                                    for a in alone),
            "counts_equal": len(counts) == 1,
            "n_outer": alone[0].n_outer,
        })
    return {"device": torch.cuda.get_device_name(0)
            if torch.device(device).type == "cuda" else "cpu",
            "repeats": repeats, "batched_repeats": batched_repeats,
            "atol": ATOL, "jobs": jobs,
            "alone_spread": max(j["alone_vs_alone"] for j in jobs),
            "batched_spread": max(j["batched_vs_alone"] for j in jobs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--batched-repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_probe(args.repeats, args.batched_repeats,
                               args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
