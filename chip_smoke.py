#!/usr/bin/env python3
"""Drive the PyTorch port's CP-APR and CP-ALS paths on one NVIDIA card.

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
   or f32 operations over 67 TFLOP/s, whichever is larger).  The Φ
   kernels are also run by direct launch of their C entry points, checked
   and timed (not counted) beside their wrappers: device and host ms per
   call of a back-to-back loop, which says where such calls are
   host-bound, and device ms per call inside a CUDA graph (the record's
   ``direct_ms``), which leaves the host out.
3. Solve: the launch counts are zeroed, ``cpapr_mu`` runs with
   ``strategy="cuda"`` from the seeded starting model, and the counts are
   read: ``phi_blocked`` must have run once per mode update and
   ``phi_mu_blocked`` once per inner iteration.  The same solve with
   ``strategy="segment"`` on the card is the reference: both
   log-likelihood histories must be finite and nondecreasing and agree.
4. MTTKRP kernel: on every mode of the same tensor the sparse MTTKRP
   kernel (``mttkrp_blocked``) runs on the starting model's Khatri-Rao
   rows and is held against its plain version.  Its library yardstick is
   the ``segment`` ``krao_reduce_rows`` (a multiply and ``index_add_``).
   Then, as in phase 2, by direct launch beside the wrapper.
5. CP-ALS, counted: the counts are zeroed, ``cp_als`` runs with
   ``strategy="cuda"`` for 10 iterations from the seeded starting model,
   and ``mttkrp_blocked`` must have run once per mode update; its fits
   must be finite and agree with ``cp_als(strategy="segment")`` on the
   card from the same start.
6. The dense tier at its cap: a near-dense (128, 256, 128) tensor
   (exactly ``DENSE_MAX_ELEMS`` cells, fill 0.40, values Poisson(2) + 1)
   is made from the seed.  On every mode the dense Φ, fused Φ -> MU and
   MTTKRP kernels are held against their plain versions, then, as in
   phase 2, run by direct launch beside the wrappers (each also checked
   bitwise equal from call to call); then
   ``cpapr_mu(strategy="dense")`` (counted: ``dense_phi`` once per mode
   update, ``dense_phi_mu`` once per inner iteration) is held against
   the ``segment`` solve, and ``cp_als(strategy="dense")`` (counted:
   ``dense_mttkrp`` once per mode update) against ``segment`` CP-ALS.
7. STREAM (paper Exp. 7): arrays of 2^28 elements (1 GiB in f32, far
   above the 50 MB L2) made on the card from the seed.  For copy, scale,
   add and triad the kernel (``stream_op``) must be bitwise equal to its
   plain version in f32 and in bf16.  Then, counted, each op's kernel is
   timed in f32 beside its plain version and the one PyTorch call that
   computes the same function (``out.copy_(b)``, ``torch.mul``,
   ``torch.add``, ``torch.add(alpha=s)``): GB/s of both and their ratio.
   Then the sweep of block_rows (which no longer shapes the launch: the
   spread should be noise) for all four ops.
8. Roofline and PPA (paper Sec. 3.2-3.3): the card's HardwareSpec, the
   paper-literal Φ intensity at rank 16 in 4-byte words, the Eq. 2 bound
   from the datasheet bandwidth and from phase 7's triad rate, and the
   GFLOP/s phase 2's Φ kernel reached on each uber mode (W = nnz(4R+2)).
   Then pressure-point analysis of the ``segment`` Φ on every uber mode
   under all four perturbations.
9. Policy grid search (paper Exps. 3-6): on every uber mode, ``segment``
   and the Φ kernel at block_nnz 64-1024 x block_rows 64-512 (plus the
   ``cuda`` heuristic's point if it is off the grid), each probe a host
   layout build and a CUDA-event timing of ``phi_from_rows(strategy=
   "cuda")``.  Per mode: the default (256 x 256), heuristic, best and
   worst points and the failed ones; best speedup over the default and
   its geomean, and the heuristic's regret (flagged as open above 1.10);
   the Φ kernel's launches must equal the timed calls.

10. One launch per fused dense step: the device kernels of one
    ``phi_mu_dense`` call on the near-dense tensor's mode 0, counted with
    torch.profiler (last, so that no timed phase runs under its set-up):
    one accumulation kernel and at most one fill of a few bytes.

Phases 7-9 print their own times.  The line before the last is the per-kernel JSON record; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
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
ALS_ITERS = 10  # CP-ALS iterations of phases 5 and 6
TIMED_ITERS = 100  # extra CP-ALS iterations of the seconds-per-iteration runs
# CP-ALS fits, kernel path vs segment on the card.  A fit is
# 1 - sqrt(|X|^2 - 2<X, M> + |M|^2) / |X| in f32: near 1 - 1.7e-4 on uber,
# so its resolution is one f32 ulp of 1.0 (6e-8).  The kernel's per-call
# differences from reordered sums (at most KERNEL_RTOL, measured ~1e-5)
# pass through 10 x ndim ridge solves of the (R, R) normal equations; 1e-6
# (16 ulps) bounds that and is still far below the fit's own change over
# the 10 iterations (4e-6 on uber, 7e-4 on the near-dense tensor).
FIT_ATOL = 1e-6
TIMING_ITERS = 20  # launches per CUDA-event timing
TIMING_WARMUP = 2  # untimed launches before each CUDA-event timing
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
STREAM_N = 1 << 28  # elements per STREAM array (phase 7)
STREAM_S = 3.0  # the scalar of scale and triad
STREAM_BLOCK_ROWS = (8, 32, 64, 256, 1024)  # phase 7's block_rows sweep
GRID_BLOCK_NNZ = (64, 128, 256, 512, 1024)  # phase 9's grid
GRID_BLOCK_ROWS = (64, 128, 256, 512)
HEURISTIC_REGRET_OPEN = 1.10  # phase 9: a regret above this is an open item
PPA_ITERS = 5  # timed calls per perturbation (median), after 2 untimed
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "phi_blocked": ("phi.cu", "src/repro/kernels/phi/kernel.py:139"),
    "phi_mu_blocked": ("phi.cu", "src/repro/kernels/phi/kernel.py:179"),
    "mttkrp_blocked": ("mttkrp.cu", "src/repro/kernels/mttkrp/kernel.py:50"),
    "dense_phi_mu": ("dense.cu", "src/repro/kernels/dense/kernel.py:239"),
    "dense_phi": ("dense.cu", "src/repro/kernels/dense/kernel.py:208"),
    "dense_mttkrp": ("dense.cu", "src/repro/kernels/dense/kernel.py:178"),
    **{f"stream_{op}": ("stream.cu", "src/repro/kernels/stream/kernel.py:36")
       for op in ("copy", "scale", "add", "triad")},
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


def new_rows(names) -> dict:
    return {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
                "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "direct_ms": 0.0, "bytes": 0, "ops": 0, "calls_ms": []}
            for k in names}


def tally(rows: dict, name: str, what: str, checks: list, times: tuple,
          nbytes: int, nops: int, lib_label: str) -> None:
    """Print one kernel call's check and times, fail on a disagreement,
    and add the call to the kernel's row (``library_ms`` None where no
    single PyTorch call computes the function)."""
    abs_e = max(c[0] for c in checks)
    rel_e = max(c[1] for c in checks)
    ok = all(c[2] for c in checks)
    ms, plain_ms, lib_ms = times
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"{what} {name}: max abs err {abs_e:.3e}, max rel err {rel_e:.3e} "
          f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib_label} {lib}, bound {bound:.4f} ms")
    check(ok, f"{name} disagrees with its plain version: {what}")
    row = rows[name]
    row["max_abs_err"] = max(row["max_abs_err"], abs_e)
    row["max_rel_err"] = max(row["max_rel_err"], rel_e)
    row["ms"] += ms
    row["calls_ms"].append(ms)
    row["plain_ms"] += plain_ms
    row["library_ms"] = (None if lib_ms is None or row["library_ms"] is None
                         else row["library_ms"] + lib_ms)
    row["bound_ms"] += bound
    row["bytes"] += nbytes
    row["ops"] += nops


def device_and_host_ms(fn, *args, iters: int) -> tuple:
    """Per call of ``fn`` over ``iters`` back-to-back calls after
    TIMING_WARMUP untimed ones: device ms from CUDA events, and host ms
    from the host clock around the same loop (the time to enqueue, before
    the closing synchronize).  Where the host's exceeds the device's, the
    loop is host-bound."""
    import torch

    for _ in range(TIMING_WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    host = time.perf_counter() - t0
    stop.synchronize()
    return start.elapsed_time(stop) / iters, 1e3 * host / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` with no host time in the way: ``iters``
    calls captured into one CUDA graph (after an untimed call that loads
    the library and caches the launch set-up), replayed between CUDA
    events.  Allocations inside come from the graph's own pool."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(fn) -> list:
    """(name, count) of the device kernels one call of ``fn`` runs, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        dev_us = (getattr(ev, "device_time_total", 0)
                  or getattr(ev, "cuda_time_total", 0))
        if dev_us > 0:
            out.append((ev.key, ev.count))
    return out


def one_launch_phase(x, c, a, b) -> None:
    """Phase 10: the device kernels of one fused dense step, counted with
    torch.profiler (last, so that the profiler's set-up touches no timed
    phase): one accumulation kernel and at most one fill of a few bytes."""
    from repro_torch.kernels.dense import ops

    kernels = device_kernels(lambda: ops.phi_mu_dense(x, c, a, b))
    print("phi_mu_dense device kernels per call: "
          + ", ".join(f"{name[:90]} x{n}" for name, n in kernels))
    check(sum(n for name, n in kernels if "dense_accum_kernel" in name) == 1
          and sum(n for _, n in kernels) <= 2,
          f"the fused dense step is not one kernel launch: {kernels}")


def direct_and_wrapper(title: str, calls, timing_iters: int) -> dict:
    """Time each ``(name, fn)`` of ``calls`` with ``device_and_host_ms``
    (device and host ms per call of a back-to-back loop) and, for the
    direct launches, with ``graph_ms`` (device ms with the host out of the
    way); print one line; returns ``{name: graph device ms per call}``
    for the names ending in "direct"."""
    out, parts = {}, []
    for name, fn in calls:
        dev_ms, host_ms = device_and_host_ms(fn, iters=timing_iters)
        part = f"{name} {dev_ms:.4f} ms (host {host_ms:.4f} ms"
        if name.endswith("direct"):
            out[name] = graph_ms(fn, timing_iters)
            part += f", graph {out[name]:.4f} ms"
        parts.append(part + ")")
    print(f"{title}, device ms per call of a loop (host ms to enqueue, "
          f"device ms per call in a CUDA graph): " + ", ".join(parts))
    return out


def direct_launch(lay, vals_e, pi_e, b, plain, mode: int,
                  timing_iters: int) -> dict:
    """Phase 2b: the Φ kernels by direct launch of their C entry points
    (``kernels/phi/kernel.py``, only a zeroed output allocated around
    them) beside their wrappers (``ops``): each held against the plain
    versions, then device and host ms per call.  Not counted (the counted
    run is phase 3's solve).  Returns the direct launches' device ms."""
    import torch

    from repro_torch.core.layout import pad_rows
    from repro_torch.kernels.phi import kernel, ops

    lt = lay.on(b.device)
    b_pad = pad_rows(b, lay.n_rows_pad)
    args = (lt.grid_rb, vals_e, lt.local_rows, pi_e, b_pad)
    kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows, eps=1e-10)

    def phi_direct():
        phi = torch.zeros(b_pad.shape, dtype=torch.float32, device=b.device)
        kernel.launch_phi(*args, phi, **kw)
        return phi

    def mu_direct():
        phi = torch.zeros(b_pad.shape, dtype=torch.float32, device=b.device)
        mu = torch.empty_like(b_pad)
        viol = torch.zeros((), dtype=torch.float32, device=b.device)
        kernel.launch_phi_mu(*args, phi, mu, viol, **kw)
        return mu, viol

    phi_p, mu_p, viol_p = plain
    phi = phi_direct()
    mu, viol = mu_direct()
    torch.cuda.synchronize()
    errs = [errors(phi, phi_p), errors(mu, mu_p), errors(viol, viol_p)]
    check(all(e[2] for e in errs),
          f"phi kernel by direct launch disagrees with its plain version on "
          f"mode {mode}")
    ms = direct_and_wrapper(f"mode {mode} Φ kernels", (
        ("phi direct", phi_direct),
        ("phi wrapper", lambda: ops.phi_blocked(lay, vals_e, pi_e, b)),
        ("phi_mu direct", mu_direct),
        ("phi_mu wrapper", lambda: ops.phi_mu_blocked(lay, vals_e, pi_e, b))),
        timing_iters)
    return {"phi_blocked": ms["phi direct"],
            "phi_mu_blocked": ms["phi_mu direct"]}


def kernel_phase(t, init, mvs, layouts, timing_iters: int) -> dict:
    import torch

    from repro_torch.core.layout import pad_rows
    from repro_torch.core.phi import expand_to_layout, phi_from_rows, phi_mu_step
    from repro_torch.core.pi import pi_rows
    from repro_torch.kernels.phi import ops, ref
    from repro_torch.perf.timing import cuda_ms

    dev = t.device
    r = init.rank
    rows = new_rows(("phi_blocked", "phi_mu_blocked"))
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
        direct = direct_launch(lay, vals_e, pi_e, b, (phi_p, mu_p, viol_p),
                               n, timing_iters)
        sizes = {"phi_blocked": (phi_bytes, phi_ops_n),
                 "phi_mu_blocked": (mu_bytes, mu_ops_n)}
        what = (f"mode {n} (rows {mv.n_rows}, nnz {nnz}, grid steps "
                f"{lay.n_grid}, pad {lay.pad_fraction:.3f})")
        for name in rows:
            tally(rows, name, what, checks[name], times[name], *sizes[name],
                  "segment index_add_")
            rows[name]["direct_ms"] += direct[name]
    return rows


def mttkrp_phase(t, init, mvs, layouts, timing_iters: int) -> dict:
    """Phase 4: the sparse MTTKRP kernel on every mode of the tensor."""
    import torch

    from repro_torch.core.phi import expand_to_layout, krao_reduce_rows
    from repro_torch.core.pi import pi_rows
    from repro_torch.kernels.mttkrp import kernel, ops, ref
    from repro_torch.perf.timing import cuda_ms

    dev = t.device
    r = init.rank
    rows = new_rows(("mttkrp_blocked",))
    for n, (mv, lay) in enumerate(zip(mvs, layouts)):
        kr = pi_rows(mv.sorted_idx, init.factors, n)
        vals_e, kr_e = expand_to_layout(lay, mv.sorted_vals, kr)
        lt = lay.on(dev)
        plain_args = (lt.grid_rb, vals_e, lt.local_rows, kr_e)
        kw = dict(block_nnz=lay.block_nnz, block_rows=lay.block_rows,
                  n_rows_pad=lay.n_rows_pad)
        got = ops.mttkrp_blocked(lay, vals_e, kr_e)
        torch.cuda.synchronize()
        want = ref.mttkrp_blocked_ref(*plain_args, **kw)
        # per nonzero its value, local row and Khatri-Rao row (~72 bytes
        # at R = 16, f32); the f32 window written once
        isz = kr_e.element_size()
        nbytes = (mv.nnz * (isz + 4 + r * isz) + 4 * lay.n_grid
                  + 4 * lay.n_rows_pad * r)
        seg = (mv.rows, mv.sorted_vals, kr, mv.n_rows)
        times = (
            cuda_ms(ops.mttkrp_blocked, lay, vals_e, kr_e,
                    iters=timing_iters),
            cuda_ms(ref.mttkrp_blocked_ref, *plain_args, **kw,
                    iters=timing_iters),
            cuda_ms(krao_reduce_rows, *seg, strategy="segment", device=dev,
                    iters=timing_iters))
        tally(rows, "mttkrp_blocked",
              f"mode {n} (rows {mv.n_rows}, nnz {mv.nnz})",
              [errors(got, want)], times, nbytes, 2 * r * mv.nnz,
              "segment krao_reduce_rows")

        # phase 4b: by direct launch of the C entry point, beside the
        # wrapper (not counted)
        def direct():
            out = torch.zeros((lay.n_rows_pad, r), dtype=torch.float32,
                              device=dev)
            kernel.launch_mttkrp(*plain_args, out, block_nnz=lay.block_nnz,
                                 block_rows=lay.block_rows)
            return out

        got = direct()
        torch.cuda.synchronize()
        check(errors(got, want)[2], f"mttkrp kernel by direct launch "
                                    f"disagrees with its plain version on "
                                    f"mode {n}")
        ms = direct_and_wrapper(f"mode {n} MTTKRP kernel", (
            ("mttkrp direct", direct),
            ("mttkrp wrapper", lambda: ops.mttkrp_blocked(lay, vals_e,
                                                          kr_e))),
            timing_iters)
        rows["mttkrp_blocked"]["direct_ms"] += ms["mttkrp direct"]
    return rows


def timed_cp_als(t, init, strategy: str, dev, counts=None) -> tuple:
    """(fits, steady seconds per iteration, launch counts) of ``cp_als``
    from ``init``.

    After an untimed 1-iteration warm-up (first-use costs: library
    loads, the solver's workspaces) the ALS_ITERS solve gives the fits;
    ``counts`` is the kernel module whose launch counts it is held to,
    zeroed just before it and read just after (None without).  Then a
    1-iteration solve is subtracted from a 1 + TIMED_ITERS one, so
    set-up (mode sorts, layouts, densified modes) is left out and its
    run-to-run spread is divided by TIMED_ITERS."""
    import torch

    from repro_torch.core.cpals import cp_als

    def run(iters):
        t0 = time.perf_counter()
        fits = cp_als(t, RANK, n_iters=iters, init=init, strategy=strategy,
                      device=dev)[1]
        torch.cuda.synchronize()
        return fits, time.perf_counter() - t0

    run(1)
    if counts is not None:
        counts.reset_launch_counts()
    fits, _ = run(ALS_ITERS)
    launched = None if counts is None else dict(counts.launch_counts)
    secs = [run(n)[1] for n in (1, 1 + TIMED_ITERS)]
    return fits, (secs[1] - secs[0]) / TIMED_ITERS, launched


def als_against_segment(t, init, strategy: str, kernel: str, ops,
                        dev) -> int:
    """Run ``cp_als(strategy)`` counted, then ``segment``; check the fits
    and the launch count of ``kernel`` (once per mode update)."""
    fits, spi, counted = timed_cp_als(t, init, strategy, dev, counts=ops)
    launches = counted[kernel]
    ref_fits, ref_spi, _ = timed_cp_als(t, init, "segment", dev)
    print(f"cp_als {strategy}: fits {fits}, {spi:.6f} s per iteration, "
          f"{kernel} launches {launches}")
    print(f"cp_als segment: fits {ref_fits}, {ref_spi:.6f} s per iteration")
    check(launches == ALS_ITERS * t.ndim,
          f"{kernel} launched {launches} times, expected "
          f"{ALS_ITERS * t.ndim} (one per mode update)")
    check(all(math.isfinite(f) for f in fits + ref_fits),
          f"non-finite CP-ALS fit: {fits} / {ref_fits}")
    fit_err = max(abs(a - b) for a, b in zip(fits, ref_fits))
    print(f"cp_als {strategy} vs segment: fit max abs diff {fit_err:.3e} "
          f"(atol {FIT_ATOL})")
    check(fit_err <= FIT_ATOL, f"{strategy} CP-ALS fits disagree")
    return launches


def dense_kernel_phase(t, init, timing_iters: int) -> dict:
    """Phase 6a: the three dense kernels on every mode of ``t``."""
    import torch

    from repro_torch.core.dense import build_dense_mode
    from repro_torch.core.phi import _dense_operands
    from repro_torch.core.sparse_tensor import sort_mode
    from repro_torch.kernels.dense import ops, ref
    from repro_torch.perf.timing import cuda_ms

    r = init.rank
    rows = new_rows(("dense_phi_mu", "dense_phi", "dense_mttkrp"))
    first = None
    for n in range(t.ndim):
        mv = sort_mode(t, n)
        dn = build_dense_mode(mv.sorted_idx, mv.sorted_vals, t.shape, n,
                              device=t.device)
        b = init.factors[n] * init.lam[None, :]
        x, c, a = _dense_operands(dn, init.factors, b)
        first = first or (x, c, a, b)
        k, i, j = x.shape
        phi_k = ops.phi_dense(x, c, a, b)
        mu_k, viol_k = ops.phi_mu_dense(x, c, a, b)
        m_k = ops.mttkrp_dense(x, c, a)
        torch.cuda.synchronize()
        phi_p = ref.phi_dense_ref(x, c, a, b, 1e-10)
        mu_p, viol_p = ref.phi_mu_dense_ref(x, c, a, b, 1e-10)
        m_p = ref.mttkrp_dense_ref(x, c, a)
        # bytes: x, c, a (and B) read once, the (I, R) result written once;
        # operations: per cell 2R for the model value, one divide and 2R
        # for the back-contraction (MTTKRP: 2R), c∘a_k per slice, the a
        # scaling per (k, i, r), and 4 per entry for the MU epilogue
        isz = x.element_size()
        cells = k * i * j
        inputs = isz * (cells + (j + k) * r)
        out = 4 * i * r
        phi_ops_n = cells * (4 * r + 1) + k * j * r + 2 * k * i * r
        sizes = {
            "dense_phi": (inputs + isz * i * r + out, phi_ops_n),
            "dense_phi_mu": (inputs + 2 * isz * i * r + 4, phi_ops_n
                             + 4 * i * r),
            "dense_mttkrp": (inputs + out, cells * 2 * r + 2 * k * i * r),
        }
        times = {
            "dense_phi": (
                cuda_ms(ops.phi_dense, x, c, a, b, iters=timing_iters),
                cuda_ms(ref.phi_dense_ref, x, c, a, b, 1e-10,
                        iters=timing_iters),
                None),
            "dense_phi_mu": (
                cuda_ms(ops.phi_mu_dense, x, c, a, b, iters=timing_iters),
                cuda_ms(ref.phi_mu_dense_ref, x, c, a, b, 1e-10,
                        iters=timing_iters),
                None),
            "dense_mttkrp": (
                cuda_ms(ops.mttkrp_dense, x, c, a, iters=timing_iters),
                cuda_ms(ref.mttkrp_dense_ref, x, c, a, iters=timing_iters),
                cuda_ms(torch.einsum, "kij,jr,kr->ir", x, c, a,
                        iters=timing_iters)),
        }
        checks = {"dense_phi": [errors(phi_k, phi_p)],
                  "dense_phi_mu": [errors(mu_k, mu_p),
                                   errors(viol_k, viol_p)],
                  "dense_mttkrp": [errors(m_k, m_p)]}
        what = f"dense mode {n} (K {k}, I {i}, J {j})"
        for name in rows:
            tally(rows, name, what, checks[name], times[name], *sizes[name],
                  "einsum" if name == "dense_mttkrp" else "single call")
        direct = dense_direct(x, c, a, b, (phi_p, mu_p, viol_p, m_p), n,
                              timing_iters)
        for name in rows:
            rows[name]["direct_ms"] += direct[name]
    return rows, first


def dense_direct(x, c, a, b, plain, mode: int, timing_iters: int) -> dict:
    """Phase 6a': the dense kernel by direct launch of its C entry points
    (only the outputs allocated around them, the work buffers the
    launcher's own) beside
    the wrappers: each held against its plain version and checked bitwise
    equal from call to call (the partials are summed in a fixed order),
    then device and host ms per call.  Not counted.  Returns the direct
    launches' device ms."""
    import torch

    from repro_torch.kernels.dense import kernel, ops

    k, i, j = x.shape
    r = c.shape[1]
    shapes = {name: kernel.launch_shape(k, i, j, r, x.dtype, name)
              for name in kernel.OPS}
    print(f"dense mode {mode} launch shapes: " + ", ".join(
        f"{name} ti {sh.ti} jc {sh.jc} n_ks {sh.n_ks} ({sh.n_itiles * sh.n_ks}"
        f" CTAs, {sh.smem} B shared)" for name, sh in shapes.items()))

    def window():
        return torch.empty((i, r), dtype=torch.float32, device=x.device)

    def phi_direct():
        sh = shapes["dense_phi"]
        phi, (part, tickets) = window(), kernel.workspace(sh, x.device)
        kernel.launch_phi(x, c, a, b, phi, part, tickets, sh, eps=1e-10)
        return phi

    def mu_direct():
        sh = shapes["dense_phi_mu"]
        mu = torch.empty_like(b)
        viol = torch.zeros((), dtype=torch.float32, device=x.device)
        part, tickets = kernel.workspace(sh, x.device)
        kernel.launch_phi_mu(x, c, a, b, mu, viol, part, tickets, sh,
                             eps=1e-10)
        return mu, viol

    def mttkrp_direct():
        sh = shapes["dense_mttkrp"]
        out, (part, tickets) = window(), kernel.workspace(sh, x.device)
        kernel.launch_mttkrp(x, c, a, out, part, tickets, sh)
        return out

    phi_p, mu_p, viol_p, m_p = plain
    phi, (mu, viol), m = phi_direct(), mu_direct(), mttkrp_direct()
    again = (phi_direct(), *mu_direct(), mttkrp_direct())
    torch.cuda.synchronize()
    errs = [errors(phi, phi_p), errors(mu, mu_p), errors(viol, viol_p),
            errors(m, m_p)]
    check(all(e[2] for e in errs),
          f"dense kernels by direct launch disagree with their plain "
          f"versions on mode {mode}")
    check(all(torch.equal(u, v) for u, v in zip((phi, mu, viol, m), again)),
          f"dense kernels not bitwise reproducible on mode {mode}")
    ms = direct_and_wrapper(f"dense mode {mode} kernels", (
        ("dense_phi_mu direct", mu_direct),
        ("dense_phi_mu wrapper", lambda: ops.phi_mu_dense(x, c, a, b)),
        ("dense_phi direct", phi_direct),
        ("dense_phi wrapper", lambda: ops.phi_dense(x, c, a, b)),
        ("dense_mttkrp direct", mttkrp_direct),
        ("dense_mttkrp wrapper", lambda: ops.mttkrp_dense(x, c, a))),
        timing_iters)
    return {k: ms[f"{k} direct"]
            for k in ("dense_phi_mu", "dense_phi", "dense_mttkrp")}


def dense_solve_phase(t, init, dev) -> dict:
    """Phase 6b: the dense CP-APR and CP-ALS solves, counted."""
    import torch

    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.kernels.dense import ops

    cfg = dict(rank=RANK, max_outer=MAX_OUTER, max_inner=MAX_INNER)
    ops.reset_launch_counts()
    res = cpapr_mu(t, RANK, init=init, device=dev,
                   config=CPAPRConfig(strategy="dense", **cfg))
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    n_updates = res.n_outer * t.ndim
    print(f"dense solve: {res.n_outer} sweeps, inner iterations "
          f"{res.inner_iters}, launches {launches}")
    print(f"  loglik {res.loglik_history}")
    print(f"  seconds per sweep {res.sweep_seconds}")
    check(res.recoveries is None, f"guard recoveries: {res.recoveries}")
    check(launches["dense_phi"] == n_updates,
          f"dense_phi launched {launches['dense_phi']} times, expected "
          f"{n_updates} (one per mode update)")
    check(launches["dense_phi_mu"] == sum(res.inner_iters) > 0,
          f"dense_phi_mu launched {launches['dense_phi_mu']} times, "
          f"expected {sum(res.inner_iters)} (one per inner iteration)")
    ref = cpapr_mu(t, RANK, init=init, device=dev,
                   config=CPAPRConfig(strategy="segment", **cfg))
    print(f"segment solve (dense tensor): inner iterations {ref.inner_iters}")
    print(f"  loglik {ref.loglik_history}")
    print(f"  seconds per sweep {ref.sweep_seconds}")
    ll, rll = res.loglik_history, ref.loglik_history
    check(len(ll) == len(rll) == res.n_outer
          and all(math.isfinite(x) for x in ll + rll),
          f"log-likelihoods not finite or of different lengths: {ll} / {rll}")
    check(monotone(ll) and monotone(rll),
          f"log-likelihood decreased: {ll} / {rll}")
    ll_err = max(abs(a - b) / abs(b) for a, b in zip(ll, rll))
    print(f"dense vs segment: loglik max rel diff {ll_err:.3e} "
          f"(rtol {LOGLIK_RTOL})")
    check(ll_err <= LOGLIK_RTOL, "dense log-likelihood histories disagree")
    launches["dense_mttkrp"] = als_against_segment(t, init, "dense",
                                                   "dense_mttkrp", ops, dev)
    return launches


def stream_phase(dev, seed: int, timing_iters: int) -> tuple:
    """Phase 7: the STREAM kernel at 2^28 elements; returns (rows,
    launches, triad bytes per second)."""
    import torch

    from repro_torch.kernels.stream import ops, ref
    from repro_torch.perf.timing import bandwidth_gbs, cuda_ms

    two_inputs = ("add", "triad")
    library = {  # the one PyTorch call that computes the same function
        "copy": ("out.copy_(b)", lambda b, c, out: out.copy_(b)),
        "scale": ("torch.mul(b, s, out=)",
                  lambda b, c, out: torch.mul(b, STREAM_S, out=out)),
        "add": ("torch.add(b, c, out=)",
                lambda b, c, out: torch.add(b, c, out=out)),
        "triad": ("torch.add(b, c, alpha=s, out=)",
                  lambda b, c, out: torch.add(b, c, alpha=STREAM_S, out=out)),
    }
    gen = torch.Generator(device=dev).manual_seed(seed)

    def arrays(dt):
        return tuple(torch.randn(STREAM_N, generator=gen, device=dev).to(dt)
                     for _ in range(2))

    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    b32, c32 = arrays(torch.float32)
    for dt, (b, c) in ((torch.float32, (b32, c32)),
                       (torch.bfloat16, arrays(torch.bfloat16))):
        for op in ops.STREAM_OPS:
            got = ops.stream_op(op, b, c, s=STREAM_S)
            want = ref.stream_ref(op, b, c if op in two_inputs else None,
                                  s=STREAM_S)
            same = bool(torch.equal(got.view(bits[dt]), want.view(bits[dt])))
            print(f"stream_{op} {str(dt).replace('torch.', '')} "
                  f"n=2^{STREAM_N.bit_length() - 1}: "
                  f"{'bitwise equal' if same else 'DIFFERS'} to stream_ref")
            check(same, f"stream_{op} ({dt}) is not bitwise equal to its "
                        f"plain version")
            del got, want
    del b, c

    # the STREAM path itself, counted: each op timed through stream_op
    ops.reset_launch_counts()
    ms = {op: cuda_ms(ops.stream_op, op, b32, c32, s=STREAM_S,
                      warmup=TIMING_WARMUP, iters=timing_iters)
          for op in ops.STREAM_OPS}
    launches = dict(ops.launch_counts)
    out = torch.empty_like(b32)
    rows, ratios = {}, []
    for op in ops.STREAM_OPS:
        name = f"stream_{op}"
        check(launches[name] == TIMING_WARMUP + timing_iters,
              f"{name} launched {launches[name]} times, expected "
              f"{TIMING_WARMUP + timing_iters} (one per stream_op call)")
        c_arg = c32 if op in two_inputs else None
        plain_ms = cuda_ms(ref.stream_ref, op, b32, c_arg, s=STREAM_S,
                           warmup=TIMING_WARMUP, iters=timing_iters)
        label, lib = library[op]
        lib_ms = cuda_ms(lib, b32, c32, out, warmup=TIMING_WARMUP,
                         iters=timing_iters)
        nbytes, nops = ref.stream_bytes_flops(op, STREAM_N, 4)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)
        k_gbs = bandwidth_gbs(nbytes, ms[op] / 1e3)
        l_gbs = bandwidth_gbs(nbytes, lib_ms / 1e3)
        ratios.append(k_gbs / l_gbs)
        print(f"{name} f32: kernel {ms[op]:.4f} ms = {k_gbs:.1f} GB/s "
              f"({100 * bound / ms[op]:.1f}% of the {bound:.4f} ms bound); "
              f"plain {plain_ms:.4f} ms; {label} {lib_ms:.4f} ms = "
              f"{l_gbs:.1f} GB/s; kernel/library {k_gbs / l_gbs:.3f}")
        check(math.isfinite(k_gbs) and k_gbs > 0, f"{name}: no bandwidth")
        rows[name] = {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": ms[op],
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "library_ms": lib_ms, "bytes": nbytes, "ops": nops}
    geo = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
    print(f"STREAM kernel/library GB/s geomean over the 4 ops: {geo:.3f}")
    b16, c16 = arrays(torch.bfloat16)
    for op in ops.STREAM_OPS:  # bf16 for the record; not the counted run
        k_ms = cuda_ms(ops.stream_op, op, b16, c16, s=STREAM_S,
                       warmup=TIMING_WARMUP, iters=timing_iters)
        nbytes, _ = ref.stream_bytes_flops(op, STREAM_N, 2)
        print(f"stream_{op} bf16: kernel {k_ms:.4f} ms = "
              f"{bandwidth_gbs(nbytes, k_ms / 1e3):.1f} GB/s")
    for op in ops.STREAM_OPS:  # block_rows is only the wrapper's check now
        nbytes, _ = ref.stream_bytes_flops(op, STREAM_N, 4)
        sweep = {br: cuda_ms(ops.stream_op, op, b32, c32, block_rows=br,
                             s=STREAM_S, warmup=TIMING_WARMUP,
                             iters=timing_iters)
                 for br in STREAM_BLOCK_ROWS}
        spread = max(sweep.values()) / min(sweep.values()) - 1
        print(f"stream_{op} f32 by block_rows: " + ", ".join(
            f"{br}: {t:.4f} ms = {bandwidth_gbs(nbytes, t / 1e3):.1f} GB/s"
            for br, t in sweep.items()) + f"; spread {100 * spread:.2f}%")
    triad_bps = ref.stream_bytes_flops("triad", STREAM_N, 4)[0] / (
        ms["triad"] / 1e3)
    return rows, launches, triad_bps


def roofline_ppa_phase(t, init, mvs, phi_calls_ms, triad_bps: float,
                       dev) -> None:
    """Phase 8: the paper's roofline on the card, then PPA of ``segment``."""
    from repro_torch.perf.ppa import PERTURBATIONS, run_ppa
    from repro_torch.perf.roofline import (
        attainable_gflops,
        detect_hardware_spec,
        operational_intensity_phi,
    )

    hw = detect_hardware_spec()
    print(f"hardware spec: {hw}")
    r = init.rank
    inten = operational_intensity_phi(r, "gpu", word_bytes=4)
    att = attainable_gflops(inten, hw)
    measured = dataclasses.replace(hw, hbm_bw=triad_bps)
    att_m = attainable_gflops(inten, measured)
    model_bytes = (5 * r + 2) * 4  # the paper's Q per nonzero, 4-byte words
    kernel_bytes = 4 + 4 + 4 * r  # phase 2's count: x, local row, Π row
    print(f"Φ intensity (paper Eqs. 3-4, rank {r}, 4-byte words): "
          f"{inten:.4f} FLOP/byte; Eq. 2 bound {att:.1f} GFLOP/s at the "
          f"datasheet {hw.hbm_bw / 1e9:.0f} GB/s, {att_m:.1f} GFLOP/s at "
          f"phase 7's triad {triad_bps / 1e9:.1f} GB/s")
    for n, (mv, ms) in enumerate(zip(mvs, phi_calls_ms)):
        gflops = mv.nnz * (4 * r + 2) / (ms / 1e3) / 1e9
        print(f"phi_blocked mode {n}: {ms:.4f} ms, {gflops:.1f} GFLOP/s = "
              f"{gflops / att:.2f} x the Eq. 2 bound")
        if gflops > att:
            print(f"  finding: above the paper-literal bound; the model "
                  f"reads a B and a Π row per nonzero ({model_bytes} B), "
                  f"the kernel keeps B rows in shared memory and moves "
                  f"~{kernel_bytes} B per nonzero")
    for n in range(t.ndim):
        res = run_ppa(t, init, mode=n, strategy="segment", iters=PPA_ITERS,
                      device=dev)
        secs = ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in res.seconds.items())
        spd = ", ".join(f"{k} {v:.3f}x" for k, v in res.speedup.items())
        print(f"PPA segment mode {n}: {secs}; speedup {spd}")
        check(set(res.seconds) == {str(p) for p in PERTURBATIONS}
              and all(math.isfinite(v) and v > 0
                      for v in list(res.seconds.values())
                      + list(res.speedup.values())),
              f"PPA mode {n}: missing or non-finite result {res}")


def grid_search_phase(init, mvs, dev, timing_iters: int) -> int:
    """Phase 9: policy grid search of the Φ kernel on every mode; returns
    its counted launches."""
    from repro_torch.core.layout import build_blocked_layout, mode_run_stats
    from repro_torch.core.phi import expand_to_layout, phi_from_rows
    from repro_torch.core.pi import pi_rows
    from repro_torch.core.policy import (
        PhiPolicy,
        default_policy,
        grid_search,
        heuristic_policy,
        policy_grid,
    )
    from repro_torch.kernels.phi import ops
    from repro_torch.perf.timing import cuda_ms

    grid = policy_grid(strategies=("segment", "cuda"),
                       block_nnz=GRID_BLOCK_NNZ, block_rows=GRID_BLOCK_ROWS)
    dp = default_policy(RANK)
    default = PhiPolicy(strategy="cuda", block_nnz=dp.block_nnz,
                        block_rows=dp.block_rows)
    ops.reset_launch_counts()
    calls = 0
    speedups = []
    for n, mv in enumerate(mvs):
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        rows_np = mv.rows.cpu().numpy()
        heur = heuristic_policy(mv.nnz, mv.n_rows, RANK, platform="cuda",
                                stats=mode_run_stats(rows_np, mv.n_rows))
        pols = grid + ([heur] if heur not in grid else [])

        def time_fn(p):
            if p.strategy == "segment":
                return cuda_ms(phi_from_rows, mv.rows, mv.sorted_vals, pi, b,
                               mv.n_rows, strategy="segment", device=dev,
                               warmup=TIMING_WARMUP, iters=timing_iters) / 1e3
            lay = build_blocked_layout(rows_np, mv.n_rows, p.block_nnz,
                                       p.block_rows)
            vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)

            def call():
                nonlocal calls
                calls += 1
                return phi_from_rows(mv.rows, mv.sorted_vals, pi, b,
                                     mv.n_rows, strategy="cuda", layout=lay,
                                     vals_e=vals_e, pi_e=pi_e, device=dev)

            return cuda_ms(call, warmup=TIMING_WARMUP,
                           iters=timing_iters) / 1e3

        ranked = grid_search(time_fn, pols)
        secs = {p: s for p, s, _ in ranked}
        ok = [(p, s) for p, s, e in ranked if e is None]
        failed = [(p.label(), e) for p, _, e in ranked if e is not None]
        check(default in secs and math.isfinite(secs[default])
              and math.isfinite(secs[heur]),
              f"mode {n}: the default or heuristic point failed: {failed}")
        (best, t_best), (worst, t_worst) = ok[0], ok[-1]
        slow, t_slow = [(p, t) for p, t in ok if p.strategy == "cuda"][-1]
        speedups.append(secs[default] / t_best)
        print(f"grid mode {n} (rows {mv.n_rows}, nnz {mv.nnz}): "
              f"{len(ok)} of {len(pols)} points timed; default "
              f"{default.label()} {secs[default] * 1e3:.4f} ms, heuristic "
              f"{heur.label()} {secs[heur] * 1e3:.4f} ms, best "
              f"{best.label()} {t_best * 1e3:.4f} ms, worst "
              f"{worst.label()} {t_worst * 1e3:.4f} ms (slowest kernel point "
              f"{slow.label()} {t_slow * 1e3:.4f} ms); best speedup over "
              f"default {secs[default] / t_best:.3f}x, heuristic regret "
              f"{secs[heur] / t_best:.3f}x; failed {failed or 'none'}")
        if secs[heur] / t_best > HEURISTIC_REGRET_OPEN:
            print(f"  open: heuristic regret {secs[heur] / t_best:.3f}x above "
                  f"{HEURISTIC_REGRET_OPEN} on mode {n}")
        print("  all points (ms): " + ", ".join(
            f"{p.label().rsplit(':', 1)[0]} {s * 1e3:.4f}" for p, s in ok))
    geo = math.exp(sum(math.log(x) for x in speedups) / len(speedups))
    launches = ops.launch_counts["phi_blocked"]
    print(f"grid search: best speedup over the default, geomean over modes "
          f"{geo:.3f}x (paper, GPU: 1.70x); phi_blocked launches {launches} "
          f"for {calls} timed calls")
    check(launches == calls > 0,
          f"phi_blocked launched {launches} times for {calls} calls")
    return launches


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
    from repro_torch.data.tensors import (
        NEAR_DENSE_FILL,
        make_near_dense,
        make_tensor,
    )
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

    # --- phase 4: the MTTKRP kernel against its plain version ---------
    rows.update(mttkrp_phase(t, init, mvs, layouts, TIMING_ITERS))

    # --- phase 5: CP-ALS, counted ----------------------------------------
    from repro_torch.kernels.mttkrp import ops as mttkrp_ops

    launches["mttkrp_blocked"] = als_against_segment(
        t, init, "cuda", "mttkrp_blocked", mttkrp_ops, dev)

    # --- phase 6: the dense tier at its cap --------------------------------
    t0 = time.perf_counter()
    dt = make_near_dense(seed=args.seed, device=dev)
    print(f"near-dense tensor: shape {dt.shape}, nnz {dt.nnz} (fill "
          f"{NEAR_DENSE_FILL}, seed {args.seed}), made in "
          f"{time.perf_counter() - t0:.1f} s")
    dinit = random_ktensor(dt.shape, RANK, seed=args.seed,
                           device=dev).normalize()
    dense_rows, dense_first = dense_kernel_phase(dt, dinit, TIMING_ITERS)
    rows.update(dense_rows)
    launches.update(dense_solve_phase(dt, dinit, dev))

    # --- phase 7: STREAM -------------------------------------------------
    t0 = time.perf_counter()
    stream_rows, stream_launches, triad_bps = stream_phase(
        dev, args.seed, TIMING_ITERS)
    rows.update(stream_rows)
    launches.update(stream_launches)
    print(f"phase 7 (STREAM): {time.perf_counter() - t0:.1f} s")

    # --- phase 8: roofline and PPA ---------------------------------------
    t0 = time.perf_counter()
    roofline_ppa_phase(t, init, mvs, rows["phi_blocked"]["calls_ms"],
                       triad_bps, dev)
    print(f"phase 8 (roofline, PPA): {time.perf_counter() - t0:.1f} s")

    # --- phase 9: policy grid search ---------------------------------------
    t0 = time.perf_counter()
    grid_search_phase(init, mvs, dev, TIMING_ITERS)
    print(f"phase 9 (grid search): {time.perf_counter() - t0:.1f} s")

    # --- phase 10: one launch per fused dense step ------------------------
    one_launch_phase(*dense_first)

    where = {k: (f"near-dense {dt.shape}" if k.startswith("dense")
                 else args.tensor) for k in rows}
    timed = {k: f"sum over the modes of one call each, {where[k]}, rank {RANK}"
             for k in rows}
    timed.update({k: f"one call on 2^28 f32 elements, s = {STREAM_S}"
                  for k in rows if k.startswith("stream")})
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": f"{CSRC}/{KERNELS[k][0]}",
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": v["max_abs_err"], "max_rel_err": v["max_rel_err"],
         "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": "bytes"
         if v["bytes"] / HBM_BYTES_PER_S >= v["ops"] / F32_OPS_PER_S
         else "operations",
         "library_ms": v["library_ms"],
         "direct_ms": v.get("direct_ms"),
         "timed": timed[k]}
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
