#!/usr/bin/env python3
"""Drive the PyTorch port's CP-APR MU path on one NVIDIA card and check it.

  python3 chip_smoke.py                      # uber, scale 1.0, rank 16
  python3 chip_smoke.py --tensor nell2       # the 77M-nonzero tensor

Run from the root of a checkout: it imports ``repro_torch`` from ``src/``
and builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc into ``build/kernels/``.  It needs a CUDA device and exits nonzero,
printing no result, without one.

Phases (any failure exits nonzero before the last line):

1. Card and build: the ``nvidia-smi`` name and power limit, the kernel
   build time and the compiler's register/shared-memory report.  TF32 is
   switched off for matmuls and cuDNN, so every f32 product is full f32.
2. Kernels: the FROSTT-shaped tensor at its published size is made on
   the card from the seed; on every mode (uber's 24-row mode 1 is the hub
   case) the Φ kernel (``phi_blocked``) and the fused Φ -> MU kernels
   (``phi_mu_blocked``) run on the starting model's inputs and are held
   against their plain PyTorch versions on the same inputs.  Times: the
   kernel, its plain version, the ``segment`` strategy's ``index_add_``
   composite as a library yardstick the port never calls for these
   kernels, and the least time the card could take (bytes over 3.35 TB/s
   or f32 operations over 67 TFLOP/s, whichever is larger).
3. Solve: the launch counts are zeroed, ``cpapr_mu`` runs with
   ``strategy="cuda"`` from the seeded starting model, and the counts are
   read: ``phi_blocked`` must have run once per mode update and
   ``phi_mu_blocked`` once per inner iteration.  The same solve with
   ``strategy="segment"`` on the card is the reference: both
   log-likelihood histories must be finite and nondecreasing and agree.

The line before the last is the per-kernel JSON record; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Kernel vs plain version, f32: both sum up to ~1.4e5 terms per Φ entry
# (uber's mode 1) in different orders (atomics vs index_add_), so entries
# may differ by a few hundred f32 ulps of the largest partial sums.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# cuda vs segment solve: the same algorithm with those per-call
# differences carried through 5 sweeps of up to 10 inner iterations.
LOGLIK_RTOL = 1e-4
KKT_RTOL = 5e-2
# log-likelihood may not fall by more than f32 rounding of its sum
MONOTONE_SLACK = 1e-6
RANK, MAX_OUTER, MAX_INNER = 16, 5, 10  # the solve the smoke test drives
TIMING_ITERS = 20  # launches per CUDA-event timing
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
SOURCE = "src/repro_torch/kernels/csrc/phi.cu"
REPLACES = {
    "phi_blocked": "src/repro/kernels/phi/kernel.py:139",
    "phi_mu_blocked": "src/repro/kernels/phi/kernel.py:179",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def errors(got, want) -> tuple:
    """(max abs error, max error relative to |want|, within tolerance)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all())
    rel = float((d / w.abs().clamp_min(KERNEL_ATOL)).max()) if d.numel() else 0.0
    return (float(d.max()) if d.numel() else 0.0), rel, ok


def kernel_phase(t, init, mvs, layouts, timing_iters: int) -> dict:
    import torch

    from repro_torch.core.layout import pad_rows
    from repro_torch.core.phi import expand_to_layout, phi_from_rows, phi_mu_step
    from repro_torch.core.pi import pi_rows
    from repro_torch.kernels.phi import ops, ref
    from repro_torch.perf.timing import cuda_ms

    dev = t.device
    r = init.rank
    rows = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bytes": 0, "ops": 0}
            for k in ("phi_blocked", "phi_mu_blocked")}
    for n, (mv, lay) in enumerate(zip(mvs, layouts)):
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
        lt = lay.on(dev)
        b_pad = pad_rows(b, lay.n_rows_pad)
        kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows,
                  eps=1e-10)
        plain_args = (lt.grid_rb, vals_e, lt.local_rows, pi_e, b_pad)

        phi_k = ops.phi_blocked(lay, vals_e, pi_e, b)
        mu_k, viol_k = ops.phi_mu_blocked(lay, vals_e, pi_e, b)
        torch.cuda.synchronize()
        phi_p = ref.phi_blocked_ref(*plain_args, **kw)
        mu_p, viol_p = ref.phi_mu_blocked_ref(*plain_args, **kw)

        # bytes each call must move: per nonzero its value, local row and
        # Π row; B read once; Φ (f32) or B*Φ + viol written once
        isz = pi_e.element_size()
        nnz = mv.nnz
        win = lay.n_rows_pad * r
        stream = nnz * (isz + 4 + r * isz) + 4 * lay.n_grid
        phi_bytes = stream + win * isz + win * 4
        mu_bytes = stream + 2 * win * isz + 4
        phi_ops_n = nnz * (4 * r + 2)
        mu_ops_n = phi_ops_n + 4 * win
        seg = (mv.rows, mv.sorted_vals, pi, b, mv.n_rows)
        times = {
            "phi_blocked": (
                cuda_ms(ops.phi_blocked, lay, vals_e, pi_e, b,
                        iters=timing_iters),
                cuda_ms(ref.phi_blocked_ref, *plain_args, **kw,
                        iters=timing_iters),
                cuda_ms(phi_from_rows, *seg, strategy="segment", device=dev,
                        iters=timing_iters)),
            "phi_mu_blocked": (
                cuda_ms(ops.phi_mu_blocked, lay, vals_e, pi_e, b,
                        iters=timing_iters),
                cuda_ms(ref.phi_mu_blocked_ref, *plain_args, **kw,
                        iters=timing_iters),
                cuda_ms(phi_mu_step, *seg, strategy="segment", device=dev,
                        iters=timing_iters)),
        }
        checks = {
            "phi_blocked": [errors(phi_k, phi_p)],
            "phi_mu_blocked": [errors(mu_k, mu_p), errors(viol_k, viol_p)],
        }
        sizes = {"phi_blocked": (phi_bytes, phi_ops_n),
                 "phi_mu_blocked": (mu_bytes, mu_ops_n)}
        for name in rows:
            abs_e = max(c[0] for c in checks[name])
            rel_e = max(c[1] for c in checks[name])
            ok = all(c[2] for c in checks[name])
            ms, plain_ms, lib_ms = times[name]
            nbytes, nops = sizes[name]
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)
            print(f"mode {n} (rows {mv.n_rows}, nnz {nnz}, grid steps "
                  f"{lay.n_grid}, pad {lay.pad_fraction:.3f}) {name}: "
                  f"max abs err {abs_e:.3e}, max rel err {rel_e:.3e} "
                  f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, segment index_add_ {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms")
            check(ok, f"{name} disagrees with its plain version on mode {n}")
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], abs_e)
            row["max_rel_err"] = max(row["max_rel_err"], rel_e)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["library_ms"] += lib_ms
            row["bound_ms"] += bound
            row["bytes"] += nbytes
            row["ops"] += nops
    return rows


def monotone(ll: list) -> bool:
    return all(b >= a - MONOTONE_SLACK * abs(a) for a, b in zip(ll, ll[1:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber", choices=("uber", "nell2"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(os.path.isdir(os.path.join(SRC, "repro_torch")),
          f"{SRC}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.core.layout import build_blocked_layout
    from repro_torch.core.policy import default_policy
    from repro_torch.core.sparse_tensor import random_ktensor, sort_mode
    from repro_torch.data.tensors import make_tensor
    from repro_torch.kernels import _build
    from repro_torch.kernels.phi import kernel, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"card: {name} ({card}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    kernel.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs.values())})")
    for p in libs.values():
        for line in p.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    t, _ = make_tensor(args.tensor, scale=args.scale, rank=RANK,
                       seed=args.seed, device=dev)
    print(f"{args.tensor}: shape {t.shape}, nnz {t.nnz} (scale {args.scale}, "
          f"seed {args.seed}), made in {time.perf_counter() - t0:.1f} s")
    init = random_ktensor(t.shape, RANK, seed=args.seed,
                          device=dev).normalize()
    mvs = [sort_mode(t, n) for n in range(t.ndim)]
    pol = default_policy(RANK)
    layouts = [build_blocked_layout(mv.rows.cpu().numpy(), mv.n_rows,
                                    pol.block_nnz, pol.block_rows)
               for mv in mvs]

    # --- phase 2: the kernels against their plain versions -------------
    rows = kernel_phase(t, init, mvs, layouts, TIMING_ITERS)

    # --- phase 3: the main path, counted --------------------------------
    cfg = dict(rank=RANK, max_outer=MAX_OUTER,
               max_inner=MAX_INNER)
    ops.reset_launch_counts()
    res = cpapr_mu(t, RANK, seed=args.seed, device=dev,
                   config=CPAPRConfig(strategy="cuda", **cfg))
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    n_updates = res.n_outer * t.ndim
    print(f"cuda solve: {res.n_outer} sweeps, inner iterations "
          f"{res.inner_iters}, launches {launches}")
    print(f"  kkt {res.kkt_history}")
    print(f"  loglik {res.loglik_history}")
    print(f"  seconds per sweep {res.sweep_seconds}")
    check(res.recoveries is None, f"guard recoveries: {res.recoveries}")
    check(launches["phi_blocked"] == n_updates,
          f"phi_blocked launched {launches['phi_blocked']} times, expected "
          f"{n_updates} (one per mode update)")
    check(launches["phi_mu_blocked"] == sum(res.inner_iters) > 0,
          f"phi_mu_blocked launched {launches['phi_mu_blocked']} times, "
          f"expected {sum(res.inner_iters)} (one per inner iteration)")
    for f in res.ktensor.factors:
        check(bool(torch.isfinite(f).all() and (f >= 0).all()),
              "non-finite or negative factor")
    ll = res.loglik_history
    check(len(ll) == res.n_outer and all(math.isfinite(x) for x in ll),
          f"log-likelihood not finite: {ll}")
    check(monotone(ll), f"log-likelihood decreased: {ll}")

    ref = cpapr_mu(t, RANK, seed=args.seed, device=dev,
                   config=CPAPRConfig(strategy="segment", **cfg))
    print(f"segment solve: inner iterations {ref.inner_iters}")
    print(f"  kkt {ref.kkt_history}")
    print(f"  loglik {ref.loglik_history}")
    print(f"  seconds per sweep {ref.sweep_seconds}")
    rll = ref.loglik_history
    check(all(math.isfinite(x) for x in rll) and monotone(rll),
          f"segment log-likelihood not finite and nondecreasing: {rll}")
    check(len(rll) == len(ll), "the two solves ran different sweep counts")
    ll_err = max(abs(a - b) / abs(b) for a, b in zip(ll, rll))
    kkt_err = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(res.kkt_history, ref.kkt_history))
    print(f"cuda vs segment: loglik max rel diff {ll_err:.3e} (rtol "
          f"{LOGLIK_RTOL}), kkt max rel diff {kkt_err:.3e} (rtol {KKT_RTOL})")
    check(ll_err <= LOGLIK_RTOL, "log-likelihood histories disagree")
    check(kkt_err <= KKT_RTOL, "KKT histories disagree")

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": v["max_abs_err"], "max_rel_err": v["max_rel_err"],
         "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": "bytes"
         if v["bytes"] / HBM_BYTES_PER_S >= v["ops"] / F32_OPS_PER_S
         else "operations",
         "library_ms": v["library_ms"],
         "timed": f"sum over the {t.ndim} modes of one call each, "
                  f"{args.tensor} rank {RANK}"}
        for k, v in rows.items()
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
