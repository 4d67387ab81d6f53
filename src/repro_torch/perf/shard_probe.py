"""Where the row-sharded tier's time goes on one card.

  python -m repro_torch.perf.shard_probe               # uber, rank 16

Prints, on a FROSTT-shaped tensor with the shards emulated on the card
(the local ``cuda`` kernels at 256 x 256):

* seconds per sweep of ``cpapr_mu`` unsharded and at S = 4, 2, 1 shards,
  both combines, with the shard-local Π (``shard_pi``) and the replicated
  one;
* the row gathers the shard-local Π makes per shard and inner iteration
  (a factor table of R f32 per row indexed by each slot), with a
  contiguous and a strided int64 index, beside the byte bound, and the
  replicated Π's gathers (``pi_rows``: a strided column of the
  coordinates) against a contiguous copy of the same index;
* the sharded S = 4 solve with the local indices handed out as strided
  column views (the port's layout) and as contiguous rows, in turns
  (contiguous, strided, strided, contiguous), each with its
  log-likelihood;
* torch.profiler's device time by kernel for one S = 4 sweep.

Needs a CUDA device.  Every line beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
import warnings

import torch

from ..core import layout as L
from ..core.cpapr import CPAPRConfig, cpapr_mu
from ..core.layout import build_blocked_layout, build_shard_pi_gather, shard_blocked_layout
from ..core.policy import PhiPolicy
from ..core.sparse_tensor import random_ktensor, sort_mode
from ..data.tensors import TENSOR_NAMES, make_tensor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _contiguous_on(self, device):
    """``ShardedPiGather.on`` with each local index a contiguous row of
    its own tensor, for the comparison only."""
    device = torch.device(device)
    key = "contiguous " + str(device)
    out = self._device_copies.get(key)
    if out is None:
        out = (tuple(torch.as_tensor(t, dtype=torch.int64, device=device)
                     for t in self.touched),
               tuple(torch.as_tensor(li, dtype=torch.int64, device=device)
                     for li in self.local_idx))
        self._device_copies[key] = out
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber", choices=TENSOR_NAMES)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shard_probe needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    warnings.simplefilter("ignore")  # the modes that fall back warn
    dev = torch.device("cuda")
    r = args.rank
    t, _ = make_tensor(args.tensor, scale=args.scale, rank=r, seed=args.seed,
                       device=dev)
    init = random_ktensor(args.seed, t.shape, r, device=dev).normalize()
    pol = PhiPolicy(strategy="cuda", block_nnz=256, block_rows=256)

    def cfg(**kw):
        base = dict(rank=r, max_outer=5, max_inner=10, strategy="sharded",
                    n_shards=4, policy=pol)
        base.update(kw)
        return CPAPRConfig(**base)

    def solve(label, **kw):
        res = cpapr_mu(t, r, init=init, device=dev, config=cfg(**kw))
        secs = res.sweep_seconds
        print(f"{label}: s/sweep {[round(x, 4) for x in secs]}, median of "
              f"sweeps 2-5 {statistics.median(secs[1:]):.4f}, inner "
              f"{res.inner_iters}, final loglik {res.loglik_history[-1]}")

    cpapr_mu(t, r, init=init, device=dev, config=cfg(max_outer=1))
    solve("unsharded cuda", strategy="cuda", n_shards=None)
    for s_count in (4, 2, 1):
        for combine in ("reduce_scatter", "psum"):
            for shard_pi in (True, False):
                solve(f"S={s_count} {combine} "
                      f"{'shard-local' if shard_pi else 'replicated'} Π",
                      n_shards=s_count, combine=combine, shard_pi=shard_pi)

    # the gathers of one shard-local Π rebuild, at S = 4 on the first mode
    # with enough row blocks
    mvs = [sort_mode(t, n) for n in range(t.ndim)]
    n = next(n for n, mv in enumerate(mvs)
             if mv.n_rows >= 4 * pol.block_rows)
    mv = mvs[n]
    sl = shard_blocked_layout(build_blocked_layout(
        mv.rows.cpu().numpy(), mv.n_rows, pol.block_nnz, pol.block_rows), 4)
    pig = build_shard_pi_gather(sl, mv.sorted_idx, n)
    touched, lidx = pig.on(dev)
    contiguous = _contiguous_on(pig, dev)[1]
    for j, m in enumerate(pig.modes):
        table = init.factors[m][touched[j][0]].contiguous()
        li, lc = lidx[j][0], contiguous[j][0]
        assert torch.equal(table[li], table[lc])
        bound = 1e3 * li.numel() * (8 + 4 * r) / HBM_BYTES_PER_S
        print(f"mode {n} shard 0, gather from mode {m}'s table "
              f"{tuple(table.shape)}, {li.numel()} rows: strided index "
              f"{_ms(lambda: table[li]):.4f} ms, contiguous "
              f"{_ms(lambda: table[lc]):.4f} ms, index_select "
              f"{_ms(lambda: torch.index_select(table, 0, lc)):.4f} ms, "
              f"bound {bound:.4f} ms")
    for m in range(t.ndim):
        if m == n:
            continue
        col = mv.sorted_idx[:, m]
        colc = col.contiguous()
        f = init.factors[m]
        bound = 1e3 * col.numel() * (8 + 4 * r) / HBM_BYTES_PER_S
        print(f"replicated Π gather, mode {m}, {col.numel()} rows from "
              f"{tuple(f.shape)}: strided column {_ms(lambda: f[col]):.4f} "
              f"ms, contiguous copy {_ms(lambda: f[colc]):.4f} ms, bound "
              f"{bound:.4f} ms")

    strided_on = L.ShardedPiGather.on
    try:
        for label, on in (("contiguous", _contiguous_on),
                          ("strided", strided_on), ("strided", strided_on),
                          ("contiguous", _contiguous_on)):
            L.ShardedPiGather.on = on
            solve(f"S=4 shard-local Π, {label} local indices")
    finally:
        L.ShardedPiGather.on = strided_on

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cpapr_mu(t, r, init=init, device=dev,
                 config=cfg(max_outer=1, track_loglik=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(ev):
        return (getattr(ev, "self_device_time_total", 0)
                or getattr(ev, "self_cuda_time_total", 0))

    evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                 key=lambda e: -dev_us(e))
    print(f"profile of one S=4 shard-local Π solve of 1 sweep (set-up "
          f"included): wall {wall:.3f} s, device self time "
          f"{sum(dev_us(e) for e in evs) / 1e3:.1f} ms")
    for e in evs[:12]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms x{e.count:5d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
