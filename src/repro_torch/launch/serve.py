"""Serving entry points: LM serving (``--arch``) and the decomposition
service's ``decomp`` subcommand.

LM serving, batched prefill + decode on one device:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --device cpu            # the reduced config, on the CPU

Builds the model (``--full``: the published config in bf16; else its
``reduced`` f32 form), draws its weights and a prompt batch from
``--seed``, generates ``--new-tokens`` tokens for ``--batch`` prompts of
``--prompt-len`` positions and prints the time and the first sequence.

The decomposition service:

  PYTHONPATH=src python -m repro_torch.launch.serve decomp
  PYTHONPATH=src python -m repro_torch.launch.serve decomp --jobs 3 \\
      --append-frac 0.2 --device cpu

Submits ``--jobs`` small cold jobs through the padded-bucket batched
path, appends a batch drawn from tenant 0's own generative model and
warm-starts it, and prints the warm-against-cold sweep receipt and the
shared autotune store's counters.  The cold yardstick is the JAX
package driver's: ``cpapr_mu`` of the merged tensor at its default
strategy (``segment``) from a fresh seeded start.  It exits nonzero if
the warm solve fails to converge where the cold one converges, or takes
more sweeps than the cold one.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..config import ShapeConfig
from ..configs import get_arch, reduced
from ..core.cpapr import CPAPRConfig, cpapr_mu
from ..core.sparse_tensor import random_poisson_tensor
from ..device import resolve_device
from ..models.api import build_model
from ..serve.decomp import DecompJob, DecompService
from ..serve.engine import Engine, ServeConfig

__all__ = ["main", "main_decomp"]


def main_decomp(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve decomp")
    ap.add_argument("--jobs", type=int, default=3,
                    help="cold jobs to submit (bucketed + batched)")
    ap.add_argument("--shape", type=int, nargs="+", default=[25, 20, 15])
    ap.add_argument("--nnz", type=int, default=3000)
    ap.add_argument("--rank", type=int, default=2)
    ap.add_argument("--append-frac", type=float, default=0.2,
                    help="appended nonzeros as a fraction of the tensor")
    ap.add_argument("--max-outer", type=int, default=40)
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--autotune-cache", default=None,
                    help="shared store path (default: a temporary file)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"[decomp] device={dev} ({_where(dev)})")
    with tempfile.TemporaryDirectory(prefix="repro-torch-serve-") as tmp:
        cache = args.autotune_cache or os.path.join(tmp, "autotune.json")
        return _drive(args, dev, cache)


def _drive(args, dev, cache: str) -> int:
    svc = DecompService(autotune_path=cache, max_outer=args.max_outer,
                        tol=args.tol, device=dev)
    shape = tuple(args.shape)
    jobs, kts = [], {}
    for j in range(args.jobs):
        t, kt = random_poisson_tensor(args.seed + j, shape, nnz=args.nnz,
                                      rank=args.rank, device=dev)
        jobs.append(DecompJob(tenant=f"tenant{j}", tensor=t, rank=args.rank))
        kts[f"tenant{j}"] = kt
    t0 = time.perf_counter()
    results = svc.submit_many(jobs)
    dt = time.perf_counter() - t0
    for r in results:
        print(f"[decomp] {r.tenant}: cold {r.result.n_outer} sweeps "
              f"(converged={r.result.converged}, batched={r.batched})")
    print(f"[decomp] {len(jobs)} jobs in {svc.n_batched_dispatches} "
          f"batched dispatch(es), {dt:.2f}s")

    # one streaming append, drawn from tenant0's own generative model
    tenant = jobs[0].tenant
    st = svc.tenant(tenant)
    extra, _ = random_poisson_tensor(
        args.seed + 1000, shape,
        nnz=max(1, int(args.append_frac * st.tensor.nnz)),
        rank=args.rank, device=dev,
        seed_ktensor=kts[tenant])
    warm = svc.append(tenant, extra.indices, extra.values)
    cold = cpapr_mu(
        st.tensor, st.rank, seed=args.seed + 2000, device=dev,
        config=CPAPRConfig(rank=st.rank, max_outer=args.max_outer,
                           tol=args.tol, track_loglik=False))
    print(f"[decomp] append frac_new={warm.frac_new:.3f} -> warm "
          f"{warm.result.n_outer} sweeps (budget {warm.sweep_budget}, "
          f"converged={warm.result.converged}) vs cold {cold.n_outer} "
          f"sweeps (converged={cold.converged})")
    if not warm.result.converged and cold.converged:
        raise SystemExit("[decomp] FAIL: warm-started solve did not reach "
                         "tolerance inside its freshness budget")
    if warm.result.n_outer > cold.n_outer:
        raise SystemExit("[decomp] FAIL: warm-start took more sweeps than "
                         "a cold solve")
    stats = svc.stats()
    print(f"[decomp] autotune: {stats['autotune']} "
          f"entries={stats['autotune_cache_entries']} (store: {cache})")
    print("[decomp] OK")
    return 0


def _where(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "decomp":
        return main_decomp(argv[1:])
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    batch = model.make_batch(args.seed + 1, shape, device=dev)
    engine = Engine(model, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature),
        device=dev)
    t0 = time.perf_counter()
    out = engine.generate(batch, seed=args.seed + 2)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"[serve] arch={cfg.name} device={dev} ({_where(dev)}) generated "
          f"{tuple(out.shape)} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"eager: no compile)")
    print("[serve] first sequence:", out[0, :16].tolist(), "...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
