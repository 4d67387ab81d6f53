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

11. Ladder and resume (run after phase 9): ``fail_strategy("cuda",
    mode=1)`` on the phase 3 solve with the ladder turned on
    (``max_demotions=4``; it is off by default) must demote mode 1
    ``cuda -> blocked``
    once and land within LOGLIK_RTOL of phase 3's log-likelihoods; the
    same solve checkpointing every sweep, killed at the start of sweep
    KILL_AT and resumed, must end within LOGLIK_RTOL of phase 3 with
    equal inner counts (B1-B3's float atomics change the last bits from
    run to run); the near-dense ``dense`` solve, killed and resumed, must
    be bitwise the uninterrupted one.  A child process launches the fused
    Φ kernel on a pointer into the null page, ladder on: the sticky
    illegal address must reach the caller unclassified, not be demoted.
12. Autotune (run after phase 11): ``policy="auto"`` on the full-width
    tensor with a fresh cache under ``build/chip_smoke/``; per mode the
    tuned policy, its probes, and the fused MU step of the tuned, default
    (256 x 256), heuristic and phase 9's best blockings timed in the same
    CUDA-graph burst harness; a second solve on the same cache (counted)
    must make zero probes and hit once per mode and agree with phase 3;
    its seconds per sweep beside phase 3's; a poisoned entry, ladder on,
    must end in ``demote_policy`` and a finished solve.
13. The decomposition service (run after phase 12), at real sizes:
    (1) SERVICE_JOBS cold rank-2 jobs of the JAX package driver's kind
    through ``submit_many``: one batched dispatch per bucket, each job
    equal in sweep and inner counts to itself solved alone through its
    bucket (factors within BUCKET_RTOL) and within UNPADDED_RTOL of the
    unpadded ``segment`` solve; jobs per second both ways.  (2) The
    phase 2 tensor as one tenant: a counted cold ``submit`` from the
    phase's starting model (log-likelihood tracked), then ``append`` of
    APPEND_FRAC of its nonzeros drawn from the planted model, warm
    started: B2 once per mode update and B1 once per inner iteration in
    both solves, every mode on ``cuda``, no demotion, log-likelihoods
    finite and nondecreasing, the warm sweeps within their budget, and
    the JAX package driver's two checks against a cold solve of the
    merged tensor from the same starting model, and the warm solve's
    final log-likelihood at least the cold one's after as many sweeps
    and after all of its own; seconds of the submit, the host merge and
    the warm solve.  (3) A tenant below the dense cut whose append carries it
    above (the JAX package test's construction at the near-dense
    shape): the cold solve runs no dense kernel, the warm one flags the
    stats move and runs B5 once per mode update and B4 once per inner
    iteration.  (4) A second tenant of the phase 2 problem is served by
    the shared autotune store (hits, no search).  (5) The dense
    workspaces stay within ``WORK_MAX`` per stream.
14. The row-sharded tier (run after phase 13), on the phase 2 tensor at
    256 x 256 with the local ``cuda`` kernels (the modes with fewer row
    blocks than shards fall back, with a warning): (1) on each sharded
    mode at S = 2 and 4, ``phi_sharded``/``krao_sharded`` (both combines,
    replicated and shard-local Π) launch B2 and B3 exactly S times per
    call and agree with ``local_strategy="blocked"`` within KERNEL_RTOL;
    every shard's kernel window is exactly zero on its padding rows; one
    sharded fused MU step per S as a CUDA-graph burst beside the
    unsharded ``cuda`` step, and each mode's ``pad_fraction``.  (2) A
    counted ``cpapr_mu(strategy="sharded", n_shards=N_SHARDS)``
    (``combine="auto"``, ``shard_pi``): a mode hook reads the launch
    counts before each mode update, so each sharded update must launch
    B2 N_SHARDS x (1 + inner) times and each fallback update B2 once and
    B1 per inner iteration, summing to the reported inner counts; log-
    likelihoods within LOGLIK_RTOL of phase 3's ``cuda`` and ``segment``
    solves, no demotion, seconds per sweep beside phase 3's.  (3) A
    counted sharded ``cp_als``: fits within FIT_ATOL of ``segment``, B3
    N_SHARDS per sharded mode and 1 per fallback mode per iteration.
    (4) A one-rank NCCL process group (``file://`` rendezvous under
    ``build/chip_smoke/``): ``cpapr_mu(mesh=make_phi_mesh(1))`` with both
    combines and ``dist_cpapr_mu`` on a (1, 1) ``("data", "model")``
    mesh, each within LOGLIK_RTOL of the emulated one-shard solve.  (5)
    Ladder on: ``fail_oom(min_shards=2)`` halves 4 -> 2 shards, a
    fingerprint fault demotes ``reduce_scatter -> psum``, a sharded solve
    killed and resumed, each within LOGLIK_RTOL of the clean one; on a
    tensor with skewed row blocks ``rebalance_every=1`` records exactly
    the re-splits the nnz weights call for, and its killed and resumed
    solve keeps them.
15. The N-D device grid (run after phase 14), on the phase 2 tensor at
    256 x 256 with the local ``cuda`` kernels, N_SHARDS cells emulated:
    (1) on every mode, the explicit grid (GRID_EXPLICIT: 1 x 4 on the
    one-row-block modes 0 and 1, 2 x 2 on 2 and 3) and the one
    ``choose_grid_shape`` picks at that blocking: ``phi_grid``,
    ``krao_grid`` and ``phi_mu_grid`` launch B2/B3 exactly A*B times per
    call and agree with ``local_strategy="blocked"`` within KERNEL_RTOL;
    every cell's kernel window is exactly zero past its shard's real
    rows and the grid-stacked B on its masked rows; one grid fused MU
    step per shape as a CUDA-graph burst beside the unsharded ``cuda``
    step and the S = N_SHARDS 1-D step, with each grid's
    ``pad_fraction`` and ``grid_scatter_wire_bytes``.  (2) Counted
    ``cpapr_mu(strategy="grid", n_shards=N_SHARDS)`` with
    ``grid_shape=None`` (the solver's own per-mode pick; modes it cannot
    grid warn and run unsharded) and with ``grid_shape=(1, 4)``: a mode
    hook reads the launch counts, so each grid update must launch B2
    A*B x (1 + inner) times and B1 never, each fallback update B2 once
    and B1 per inner iteration; log-likelihoods within LOGLIK_RTOL of
    phase 3's ``cuda`` and ``segment`` solves, no demotion, seconds per
    sweep beside phases 3 and 14.  (3) A counted grid ``cp_als``: fits
    within FIT_ATOL of ``segment``, B3 A*B per grid mode and 1 per
    fallback mode per iteration.  (4) A (1, 1) ``make_grid_mesh`` on a
    one-rank NCCL group within LOGLIK_RTOL of the emulated 1 x 1 solve.
    (5) Ladder on: ``fail_oom(min_shards=3)`` and
    ``fail_strategy("grid")`` each take the ``grid 2x2->sharded@2`` rung
    once (the kernel fault after ``local cuda->blocked``), within
    LOGLIK_RTOL of the clean 2 x 2 solve; a 1 x 4 solve killed and
    resumed ends within LOGLIK_RTOL of the uninterrupted one with equal
    counts and its checkpoint's ``mode_grids``.
10. One launch per fused dense step: the device kernels of one
    ``phi_mu_dense`` call on the near-dense tensor's mode 0, counted with
    torch.profiler (last, so that no timed phase runs under its set-up):
    one accumulation kernel and at most one fill of a few bytes.

The counted main-path solves of phases 3, 5 and 6 fail on any demotion
(``recoveries`` must be empty): a ladder that quietly ran a plain
strategy would otherwise pass as the kernel; so do phases 13's, 14's
and 15's.  Phases 7-9 and 11-15 print their own times.  The line before
the last is the per-kernel JSON record (``launches`` from the counted
runs of phases 3-7, ``service_launches`` from phase 13's,
``sharded_launches`` from phase 14's, ``grid_launches`` from phase
15's); the last is
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
KILL_AT = 3  # phases 11, 14: the sweep at whose start a solve is killed
SHARD_COUNTS = (2, 4)  # phase 14.1's shard counts
N_SHARDS = 4  # the shard count of phase 14's solves and phase 15's grids
# phase 15.1's explicit grid per uber mode: the hub-sized modes 0 and 1
# (one 256-row block each) can only split their nonzero stream
GRID_EXPLICIT = {0: (1, 4), 1: (1, 4), 2: (2, 2), 3: (2, 2)}
# phase 14.5's skewed tensor for rebalancing (the CPU tests' construction,
# scaled): SKEW_SPARSE mode-0 row blocks of 8 rows with 2 nonzeros (one
# grid step of 64 each), then 4 with SKEW_DENSE; the other modes' extents
SKEW_SPARSE, SKEW_DENSE, SKEW_OTHER = 2000, 32_000, (300, 250)
# Phase 13, the decomposition service.  The bucket tier's traffic: cold
# rank-2 jobs shaped around the JAX package driver's (25, 20, 15) with
# 2000-3000 nonzeros drawn, solved at its bucket-tier test's config.
SERVICE_JOBS = 64
SERVICE_RANK = 2
SERVICE_EXTENTS = ((18, 25), (14, 20), (10, 15))
SERVICE_NNZ = (2000, 3000)
SERVICE_CFG = dict(max_outer=12, tol=1e-3)
# a job batched against the same job alone through its bucket on the card:
# index_add_'s float atomics reorder each Φ row's sum
BUCKET_RTOL, BUCKET_ATOL = 1e-4, 1e-6
# batched against the unpadded segment solve: the JAX package's own
# tolerance for this comparison (padding reorders the sums)
UNPADDED_RTOL, UNPADDED_ATOL = 2e-3, 1e-5
APPEND_FRAC = 0.1  # the large tenant's append, a share of its nonzeros
# the dense-cut tenant: the JAX package test's (30, 8, 8) construction at
# the near-dense shape: a base drawing 150/1920 of the cells from a
# low-rank model, then 900/1920 of them uniformly at random
DENSE_CUT_BASE, DENSE_CUT_APPEND = 150 / 1920, 900 / 1920
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

    from repro_torch.kernels.dense.kernel import hold_workspaces

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # the graph writes the dense workspaces it captured: hold them
    with hold_workspaces() as _held, torch.cuda.graph(graph):
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


def timed_cp_als(t, init, strategy: str, dev, counts=None, **kw) -> tuple:
    """(fits, steady seconds per iteration, launch counts) of ``cp_als``
    from ``init``.

    After an untimed 1-iteration warm-up (first-use costs: library
    loads, the solver's workspaces) the ALS_ITERS solve gives the fits;
    ``counts`` is the kernel module whose launch counts it is held to,
    zeroed just before it and read just after (None without).  Then a
    1-iteration solve is subtracted from a 1 + TIMED_ITERS one, so
    set-up (mode sorts, layouts, densified modes) is left out and its
    run-to-run spread is divided by TIMED_ITERS.  ``kw`` goes to every
    ``cp_als`` call."""
    import torch

    from repro_torch.core.cpals import cp_als

    def run(iters, recoveries=None):
        t0 = time.perf_counter()
        fits = cp_als(t, RANK, n_iters=iters, init=init, strategy=strategy,
                      recoveries=recoveries, device=dev, **kw)[1]
        torch.cuda.synchronize()
        return fits, time.perf_counter() - t0

    run(1)
    if counts is not None:
        counts.reset_launch_counts()
    recoveries: list = []
    fits, _ = run(ALS_ITERS, recoveries)
    launched = None if counts is None else dict(counts.launch_counts)
    check(recoveries == [],
          f"cp_als {strategy} demoted a mode: {recoveries}")
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
    check(res.recoveries is None,
          f"guard recoveries or demotions: {res.recoveries}")
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


def grid_search_phase(init, mvs, dev, timing_iters: int) -> tuple:
    """Phase 9: policy grid search of the Φ kernel on every mode; returns
    its counted launches and, per mode, its fastest kernel point and
    that point's time (s)."""
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
    best_kernel = []
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
        kernel_points = [(p, t) for p, t in ok if p.strategy == "cuda"]
        slow, t_slow = kernel_points[-1]
        best_kernel.append(kernel_points[0])
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
    return launches, best_kernel


def _work_path(name: str) -> str:
    """A fresh path under ``build/chip_smoke/`` (gitignored)."""
    d = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    for stale in (path, path + ".corrupt"):
        if os.path.exists(stale):
            os.remove(stale)
    return path


def _killed_then_resumed(t, cfg, dev, **init) -> tuple:
    """Run ``cpapr_mu`` with ``cfg`` (checkpointing every sweep), kill it
    at the start of sweep KILL_AT, resume it from its checkpoint; returns
    the resumed result."""
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.testing import faults

    killed = False
    try:
        with faults.kill_at_sweep(KILL_AT):
            cpapr_mu(t, RANK, device=dev, config=cfg, **init)
    except faults.KilledError:
        killed = True
    check(killed, f"kill_at_sweep({KILL_AT}) did not fire")
    res = cpapr_mu(t, RANK, device=dev, config=cfg,
                   resume_from=cfg.checkpoint_path, **init)
    kinds = [e.kind for e in (res.recoveries or [])]
    check(kinds == ["resume"], f"resumed solve recorded {kinds}")
    return res


# A launch of the fused Φ kernel whose Π-rows pointer lies in the unmapped
# null page, in a child process: the illegal address is sticky (cudaError
# 700), so the solve must raise instead of demoting.  (A pointer to a
# buffer PyTorch had freed with empty_cache did not fault on the H100.)
STICKY_CHILD = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
from repro_torch.core.resilience import classify_failure
from repro_torch.core.sparse_tensor import random_poisson_tensor
from repro_torch.kernels.phi import kernel
t, _ = random_poisson_tensor((40, 30, 25), nnz=1500, rank=4, seed=0,
                             device="cuda")
lib = kernel.load_library()
class NullPagePi:
    def __getattr__(self, name):
        return getattr(lib, name)
    def phi_mu_blocked_launch(self, *args):
        args = list(args)
        args[4] = 256  # dtype, grid_rb, vals_e, local_rows, pi_e, ...
        return lib.phi_mu_blocked_launch(*args)
kernel.load_library = NullPagePi
try:
    res = cpapr_mu(t, 4, seed=0, device="cuda", config=CPAPRConfig(
        rank=4, max_outer=2, strategy="cuda", max_demotions=4))
except Exception as e:
    print("propagated:", type(e).__name__, "kind", classify_failure(e),
          "|", str(e).strip().splitlines()[0][:160])
    sys.exit(0 if classify_failure(e) is None else 3)
print("not propagated; recoveries:", res.recoveries)
sys.exit(1)
"""


def ladder_phase(t, res, dt, dinit, dev, seed: int) -> None:
    """Phase 11: an injected demotion on the main path, kill and resume
    on uber (``cuda``) and on the near-dense tensor (``dense``, bitwise),
    and a sticky CUDA error in a child process."""
    import torch

    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.testing import faults

    cfg = dict(rank=RANK, max_outer=MAX_OUTER, max_inner=MAX_INNER)
    with faults.fail_strategy("cuda", mode=1) as budget:
        inj = cpapr_mu(t, RANK, seed=seed, device=dev,
                       config=CPAPRConfig(strategy="cuda", max_demotions=4,
                                          **cfg))
    rec = [(e.kind, e.mode, e.detail.get("action")) for e in inj.recoveries]
    print(f"injected cuda failure on mode 1: recoveries {rec}, inner "
          f"iterations {inj.inner_iters}, loglik {inj.loglik_history}")
    check(budget == [0] and rec == [("demote_kernel", 1, "cuda->blocked")],
          f"the injected failure was not demoted once: {rec}")
    ll_err = max(abs(a - b) / abs(b)
                 for a, b in zip(inj.loglik_history, res.loglik_history))
    print(f"demoted vs clean cuda solve: loglik max rel diff {ll_err:.3e} "
          f"(rtol {LOGLIK_RTOL})")
    check(len(inj.loglik_history) == len(res.loglik_history)
          and ll_err <= LOGLIK_RTOL, "the demoted solve disagrees")

    ck = _work_path("uber_cuda.ckpt")
    resumed = _killed_then_resumed(
        t, CPAPRConfig(strategy="cuda", checkpoint_every=1,
                       checkpoint_path=ck, **cfg), dev, seed=seed)
    ll_err = abs(resumed.loglik_history[-1] - res.loglik_history[-1]) / abs(
        res.loglik_history[-1])
    print(f"uber cuda killed at sweep {KILL_AT} and resumed: inner "
          f"iterations {resumed.inner_iters} (uninterrupted "
          f"{res.inner_iters}), final loglik {resumed.loglik_history[-1]} "
          f"(uninterrupted {res.loglik_history[-1]}, rel diff {ll_err:.3e}, "
          f"rtol {LOGLIK_RTOL}); sweeps run after the resume "
          f"{len(resumed.sweep_seconds)}")
    check(resumed.inner_iters == res.inner_iters and ll_err <= LOGLIK_RTOL,
          "the resumed uber solve disagrees with the uninterrupted one")

    ref = cpapr_mu(dt, RANK, init=dinit, device=dev,
                   config=CPAPRConfig(strategy="dense", **cfg))
    dck = _work_path("near_dense.ckpt")
    dres = _killed_then_resumed(
        dt, CPAPRConfig(strategy="dense", checkpoint_every=1,
                        checkpoint_path=dck, **cfg), dev, init=dinit)
    same = (all(torch.equal(a, b) for a, b in zip(dres.ktensor.factors,
                                                  ref.ktensor.factors))
            and torch.equal(dres.ktensor.lam, ref.ktensor.lam)
            and dres.kkt_history == ref.kkt_history
            and dres.loglik_history == ref.loglik_history
            and dres.inner_iters == ref.inner_iters)
    print(f"near-dense dense killed at sweep {KILL_AT} and resumed: "
          f"factors, lam and histories bitwise equal to the uninterrupted "
          f"solve: {same}")
    check(same, "the resumed dense solve is not bitwise the uninterrupted")

    env = dict(os.environ, PYTHONPATH=SRC)
    child = subprocess.run([sys.executable, "-c", STICKY_CHILD], cwd=HERE,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    print(f"sticky fault in a child process (exit {child.returncode}): "
          f"{child.stdout.strip()}")
    check(child.returncode == 0,
          f"the sticky fault was not propagated as unclassified: "
          f"{child.stdout.strip()} {child.stderr.strip()[-400:]}")


def autotune_phase(t, init, mvs, res, grid_best, dev, seed: int) -> None:
    """Phase 12: ``policy="auto"`` on the full-width tensor with a fresh
    cache; per mode the tuned, default, heuristic and phase 9's best
    blockings timed as one CUDA-graph burst; a second solve served from
    the cache (counted, no probes); a poisoned entry demoted."""
    import statistics

    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.core.layout import mode_run_stats
    from repro_torch.core.pi import pi_rows
    from repro_torch.core.policy import PhiPolicy, default_policy, heuristic_policy
    from repro_torch.kernels.phi import ops
    from repro_torch.perf.autotune import Autotuner
    from repro_torch.perf.timing import step_burst_seconds
    from repro_torch.testing import faults

    cfg = dict(rank=RANK, max_outer=MAX_OUTER, max_inner=MAX_INNER)
    path = _work_path("autotune.json")
    tuner = Autotuner(cache_path=path)
    t0 = time.perf_counter()
    first = cpapr_mu(t, RANK, seed=seed, device=dev,
                     config=CPAPRConfig(policy="auto", autotuner=tuner, **cfg))
    print(f"auto solve with a fresh cache: {time.perf_counter() - t0:.2f} s "
          f"(tuning included), tuner {tuner.counters()}, policies "
          f"{[p.label() for p in first.policies]}")
    check(first.recoveries is None, f"auto solve recoveries: "
          f"{first.recoveries}")
    check(tuner.n_searches == t.ndim, f"{tuner.n_searches} tunes for "
          f"{t.ndim} modes")
    dp = default_policy(RANK)
    default = PhiPolicy(strategy="cuda", block_nnz=dp.block_nnz,
                        block_rows=dp.block_rows)
    width = math.prod(t.shape)
    for n, mv in enumerate(mvs):
        rows_np = mv.rows.cpu().numpy()
        key, _ = tuner.mode_key(mv.rows, mv.n_rows, RANK, stats=mode_run_stats(
            rows_np, mv.n_rows, row_width=width // t.shape[n]))
        entry = tuner.cache.entries[key]
        tuned = first.policies[n]
        heur = heuristic_policy(mv.nnz, mv.n_rows, RANK, platform="cuda",
                                stats=mode_run_stats(rows_np, mv.n_rows))
        best, best_s = grid_best[n]
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        ms = {}
        for label, pol in (("tuned", tuned), ("default", default),
                           ("heuristic", heur), ("phase 9 best", best)):
            step, _ = tuner.probe_step(pol, mv.rows, mv.sorted_vals, pi,
                                       mv.n_rows)
            ms[label] = 1e3 * step_burst_seconds(step, b, tuner.burst,
                                                 warmup=1, iters=5)
        probes = {k: round(1e3 * v, 4)
                  for k, v in entry.get("probe_seconds", {}).items()}
        print(f"autotune mode {n} (rows {mv.n_rows}, nnz {mv.nnz}): tuned "
              f"{tuned.label()} (source {entry['source']}, probes "
              f"{entry.get('probes')} of {entry.get('n_candidates')} "
              f"candidates, probe ms per step {probes})")
        print(f"  fused MU step, ms per step in a {tuner.burst}-step CUDA "
              f"graph burst: tuned {ms['tuned']:.4f}, default "
              f"{default.label()} {ms['default']:.4f}, heuristic "
              f"{heur.label()} {ms['heuristic']:.4f}, phase 9 best "
              f"{best.label()} {ms['phase 9 best']:.4f} (phase 9's own "
              f"wrapper timing of its Φ call {1e3 * best_s:.4f}); regret of "
              f"auto vs the phase 9 best {ms['tuned'] / ms['phase 9 best']:.3f}x"
              f", default/tuned {ms['default'] / ms['tuned']:.3f}x")
        check(all(math.isfinite(v) and v > 0 for v in ms.values()),
              f"mode {n}: a burst time is not finite: {ms}")

    again = Autotuner(cache_path=path)
    ops.reset_launch_counts()
    second = cpapr_mu(t, RANK, seed=seed, device=dev,
                      config=CPAPRConfig(policy="auto", autotuner=again,
                                         **cfg))
    launches = dict(ops.launch_counts)
    print(f"auto solve from the cache: tuner {again.counters()}, launches "
          f"{launches}, inner iterations {second.inner_iters}")
    check(again.n_probes == 0 and again.n_hits == t.ndim
          and again.n_searches == 0,
          f"the second solve did not serve every mode from the cache: "
          f"{again.counters()}")
    check(second.recoveries is None, f"recoveries {second.recoveries}")
    if all(p.strategy == "cuda" for p in second.policies):
        check(launches["phi_blocked"] == second.n_outer * t.ndim
              and launches["phi_mu_blocked"] == sum(second.inner_iters),
              f"auto solve launches {launches}")
    ll_err = max(abs(a - b) / abs(b) for a, b in
                 zip(second.loglik_history, res.loglik_history))
    print(f"auto vs default solve: loglik max rel diff {ll_err:.3e} (rtol "
          f"{LOGLIK_RTOL}); s/sweep (median after the first) auto "
          f"{statistics.median(second.sweep_seconds[1:]):.6f}, default "
          f"{statistics.median(res.sweep_seconds[1:]):.6f}; sweeps auto "
          f"{second.sweep_seconds}, default {res.sweep_seconds}")
    check(len(second.loglik_history) == len(res.loglik_history)
          and ll_err <= LOGLIK_RTOL, "auto solve disagrees with the default")

    poisoned = Autotuner(cache_path=_work_path("autotune_poisoned.json"),
                         measure=False)
    faults.poison_autotune(poisoned, mvs[0], RANK, shape=t.shape)
    pres = cpapr_mu(t, RANK, seed=seed, device=dev,
                    config=CPAPRConfig(policy="auto", autotuner=poisoned,
                                       rank=RANK, max_outer=2,
                                       max_inner=MAX_INNER,
                                       max_demotions=4))
    rec = [(e.kind, e.mode, e.detail.get("action"))
           for e in (pres.recoveries or [])]
    print(f"poisoned entry on mode 0: recoveries {rec}, sweeps "
          f"{pres.n_outer}, loglik {pres.loglik_history}")
    check(("demote_policy", 0, "warpspeed->segment") in rec
          and pres.n_outer == 2
          and all(math.isfinite(x) for x in pres.loglik_history),
          "the poisoned solve did not demote and finish")


def counted_solve(what: str, res, n_modes: int, launches: dict,
                  kernels: tuple, idle: tuple, total: dict) -> None:
    """Hold one counted service solve: ``kernels`` (the per-mode-update
    and the per-inner-iteration kernel) launched as the solve's counts say,
    the ``idle`` kernels not at all, no demotion, every mode on the
    kernels' strategy, finite factors.  Adds the counts into ``total``."""
    import torch

    per_update, per_inner = kernels
    strategy = "dense" if per_update.startswith("dense") else "cuda"
    print(f"{what}: {res.n_outer} sweeps, inner iterations "
          f"{res.inner_iters}, launches {launches}, seconds {res.seconds:.3f}")
    check(res.recoveries is None,
          f"{what}: guard recoveries or demotions: {res.recoveries}")
    got = [p.strategy for p in res.policies or []]
    check(got == [strategy] * n_modes,
          f"{what}: modes resolved to {got}, expected {strategy} on every "
          f"mode (no segment or plain path)")
    check(launches[per_update] == res.n_outer * n_modes,
          f"{what}: {per_update} launched {launches[per_update]} times, "
          f"expected {res.n_outer * n_modes} (one per mode update)")
    check(launches[per_inner] == sum(res.inner_iters) > 0,
          f"{what}: {per_inner} launched {launches[per_inner]} times, "
          f"expected {sum(res.inner_iters)} (one per inner iteration)")
    check(all(launches[k] == 0 for k in idle),
          f"{what}: {idle} launched: {launches}")
    check(all(bool(torch.isfinite(f).all() and (f >= 0).all())
              for f in res.ktensor.factors), f"{what}: non-finite factor")
    for k in kernels:
        total[k] = total.get(k, 0) + launches[k]


def _launch_counts() -> dict:
    from repro_torch.kernels.dense import ops as dense_ops
    from repro_torch.kernels.phi import ops as phi_ops

    return {**phi_ops.launch_counts, **dense_ops.launch_counts}


def _reset_counts() -> None:
    from repro_torch.kernels.dense import ops as dense_ops
    from repro_torch.kernels.phi import ops as phi_ops

    phi_ops.reset_launch_counts()
    dense_ops.reset_launch_counts()


def bucket_tier_part(dev, seed: int) -> None:
    """Phase 13.1: SERVICE_JOBS cold jobs through submit_many, one batched
    dispatch per bucket; each job against itself alone through its bucket
    and against the unpadded segment solve."""
    import numpy as np
    import torch

    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.core.sparse_tensor import random_poisson_tensor
    from repro_torch.serve.batch import batched_cpapr_mu
    from repro_torch.serve.decomp import DecompJob, DecompService

    rng = np.random.default_rng([seed, 13])
    jobs = []
    for j in range(SERVICE_JOBS):
        shape = tuple(int(rng.integers(lo, hi + 1))
                      for lo, hi in SERVICE_EXTENTS)
        nnz = int(rng.integers(SERVICE_NNZ[0], SERVICE_NNZ[1] + 1))
        tj, _ = random_poisson_tensor(shape, nnz=nnz, rank=SERVICE_RANK,
                                      seed=1000 * seed + j, device=dev)
        jobs.append(DecompJob(f"job{j}", tj, SERVICE_RANK, seed=seed + j))
    svc = DecompService(autotune_path=_work_path("service_buckets.json"),
                        device=dev, **SERVICE_CFG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = svc.submit_many(jobs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    buckets = {str((b.shape, b.nnz)): n for b, n in svc.registry.seen.items()}
    print(f"13.1 bucket tier: {SERVICE_JOBS} jobs in "
          f"{svc.n_batched_dispatches} batched dispatches over "
          f"{len(buckets)} buckets {buckets}")
    print(f"13.1 bucket tier: submit_many {dt:.3f} s, "
          f"{SERVICE_JOBS / dt:.1f} jobs/s; sweeps per job "
          f"{[r.result.n_outer for r in res]}")
    check(svc.n_batched_dispatches == len(buckets),
          f"{svc.n_batched_dispatches} dispatches for {len(buckets)} buckets")
    cfg = CPAPRConfig(rank=SERVICE_RANK, track_loglik=False, **SERVICE_CFG)
    worst_alone = worst_unpadded = 0.0  # max |diff| / |other|
    alone_s = 0.0
    for job, r in zip(jobs, res):
        t0 = time.perf_counter()
        (alone,), _ = batched_cpapr_mu([job.tensor], SERVICE_RANK,
                                       seeds=[job.seed], config=cfg,
                                       bucket=r.bucket, device=dev)
        alone_s += time.perf_counter() - t0
        got = r.result
        check(alone.n_outer == got.n_outer
              and alone.inner_iters == got.inner_iters,
              f"{job.tenant}: batched {got.n_outer} sweeps "
              f"{got.inner_iters}, alone {alone.n_outer} "
              f"{alone.inner_iters}")
        ref = cpapr_mu(job.tensor, SERVICE_RANK, seed=job.seed, device=dev,
                       config=dataclasses.replace(cfg, strategy="segment"))
        check(ref.converged == got.converged,
              f"{job.tenant}: converged {got.converged}, unpadded segment "
              f"{ref.converged}")
        for a, b, c in zip((got.ktensor.lam, *got.ktensor.factors),
                           (alone.ktensor.lam, *alone.ktensor.factors),
                           (ref.ktensor.lam, *ref.ktensor.factors)):
            d_alone = (a - b).abs()
            d_ref = (a - c).abs()
            check(bool((d_alone <= BUCKET_ATOL + BUCKET_RTOL * b.abs()).all()),
                  f"{job.tenant}: batched and alone differ by "
                  f"{float(d_alone.max()):.3e}")
            check(bool((d_ref <= UNPADDED_ATOL
                        + UNPADDED_RTOL * c.abs()).all()),
                  f"{job.tenant}: batched and unpadded segment differ by "
                  f"{float(d_ref.max()):.3e}")
            worst_alone = max(worst_alone, float(
                (d_alone / b.abs().clamp_min(BUCKET_ATOL)).max()))
            worst_unpadded = max(worst_unpadded, float(
                (d_ref / c.abs().clamp_min(UNPADDED_ATOL)).max()))
    print(f"13.1 bucket tier: the same jobs one at a time through their "
          f"buckets {alone_s:.3f} s, {SERVICE_JOBS / alone_s:.1f} jobs/s; "
          f"batched vs alone max rel diff {worst_alone:.3e} (rtol "
          f"{BUCKET_RTOL}, atol {BUCKET_ATOL}), vs unpadded segment "
          f"{worst_unpadded:.3e} (rtol {UNPADDED_RTOL}, atol {UNPADDED_ATOL})")


def large_tenant_part(svc, t, truth, init, name: str, dev, seed: int,
                      total: dict) -> None:
    """Phase 13.2: the full-width tensor as one tenant: a counted cold
    submit, a counted warm append of APPEND_FRAC of its nonzeros drawn
    from the planted model, the JAX package driver's two checks and the
    log-likelihood checks against a cold solve of the merged tensor, then
    13.4's shared-store check."""
    import torch

    from repro_torch.core.cpapr import CPAPRConfig, cpapr_mu
    from repro_torch.core.sparse_tensor import random_poisson_tensor
    from repro_torch.data.tensors import tensor_seed

    dense = ("dense_phi", "dense_phi_mu", "dense_mttkrp")
    _reset_counts()
    t0 = time.perf_counter()
    cold = svc.submit(name, t, RANK, init=init)
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    counted_solve("13.2 large tenant submit", cold.result, t.ndim,
                  _launch_counts(), ("phi_blocked", "phi_mu_blocked"), dense,
                  total)
    extra, _ = random_poisson_tensor(
        t.shape, nnz=int(APPEND_FRAC * t.nnz), rank=RANK,
        seed=tensor_seed(name, seed) + 1, seed_ktensor=truth, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    warm = svc.append(name, extra.indices, extra.values)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    res = warm.result
    counted_solve("13.2 large tenant warm append", res, t.ndim,
                  _launch_counts(), ("phi_blocked", "phi_mu_blocked"), dense,
                  total)
    merged = svc.tenant(name).tensor
    for what, ll in (("submit", cold.result.loglik_history),
                     ("warm append", res.loglik_history)):
        check(len(ll) > 0 and all(math.isfinite(x) for x in ll)
              and monotone(ll),
              f"13.2 {what}: log-likelihood not finite and nondecreasing: "
              f"{ll}")
    check(res.n_outer <= warm.sweep_budget,
          f"warm solve took {res.n_outer} sweeps, budget {warm.sweep_budget}")
    cold_merged = cpapr_mu(merged, RANK, seed=seed, device=dev,
                           config=CPAPRConfig(
                               rank=RANK, max_outer=MAX_OUTER,
                               max_inner=MAX_INNER, policy="auto",
                               autotuner=svc.tuner, track_loglik=True))
    print(f"13.2 large tenant: {t.nnz} nonzeros + {extra.nnz} appended "
          f"({warm.frac_new:.4f} fresh, merged {merged.nnz}); submit "
          f"{submit_s:.3f} s (solve {cold.result.seconds:.3f} s), append "
          f"{append_s:.3f} s = merge and stats (host) "
          f"{append_s - res.seconds:.3f} s + warm solve {res.seconds:.3f} s")
    print(f"13.2 large tenant: warm {res.n_outer} sweeps (budget "
          f"{warm.sweep_budget}, converged {res.converged}) vs cold of the "
          f"merged tensor {cold_merged.n_outer} sweeps (converged "
          f"{cold_merged.converged}), cold {cold_merged.seconds:.3f} s")
    cold_ll = cold_merged.loglik_history
    print(f"13.2 large tenant: loglik submit {cold.result.loglik_history}, "
          f"warm {res.loglik_history}, cold of the merged tensor {cold_ll}")
    check(res.converged or not cold_merged.converged,
          "warm-started solve did not converge where the cold one did")
    check(res.n_outer <= cold_merged.n_outer,
          "warm-started solve took more sweeps than a cold solve")
    # Neither solve converges within these budgets, so the two checks above
    # hold by construction; the log-likelihood on the merged tensor is what
    # shows the warm start's worth: at least the cold solve's after as many
    # sweeps, and at least its final one after MAX_OUTER.
    check(len(cold_ll) == cold_merged.n_outer and monotone(cold_ll)
          and all(math.isfinite(x) for x in cold_ll),
          f"13.2 cold of the merged tensor: log-likelihood {cold_ll}")
    warm_ll = res.loglik_history[-1]
    check(warm_ll >= cold_ll[min(res.n_outer, len(cold_ll)) - 1],
          f"warm solve's log-likelihood {warm_ll} below the cold solve's "
          f"{cold_ll} after {res.n_outer} sweeps")
    check(warm_ll >= cold_ll[-1],
          f"warm solve's log-likelihood {warm_ll} after {res.n_outer} sweeps "
          f"below the cold solve's {cold_ll[-1]} after {len(cold_ll)}")

    # 13.4: a second tenant of the same problem is served from the store
    before = dict(svc.stats()["autotune"])
    svc.submit(name + "-b", t, RANK, init=init, max_outer=1)
    after = svc.stats()["autotune"]
    print(f"13.4 shared store: before the second tenant {before}, after "
          f"{after}")
    check(after["hits"] - before["hits"] == t.ndim
          and after["searches"] == before["searches"],
          "the second tenant of the same shape was not served from the "
          "shared store")


def dense_cut_part(svc, dev, seed: int, total: dict) -> None:
    """Phase 13.3: a tenant below the dense cut whose append carries it
    above: the cold solve runs the Φ kernels only, the warm one flags the
    stats move and runs the dense kernels on every mode, counted."""
    import numpy as np
    import torch

    from repro_torch.core.sparse_tensor import random_poisson_tensor
    from repro_torch.data.tensors import NEAR_DENSE_SHAPE

    shape = NEAR_DENSE_SHAPE
    cells = math.prod(shape)
    base, _ = random_poisson_tensor(shape, nnz=int(DENSE_CUT_BASE * cells),
                                    rank=RANK, seed=seed + 7, device=dev)
    rng = np.random.default_rng([seed, 133])
    k = int(DENSE_CUT_APPEND * cells)
    idx = np.stack([rng.integers(0, s, size=k) for s in shape], axis=1)
    vals = rng.poisson(2.0, size=k).astype(np.float32) + 1.0
    sparse = ("phi_blocked", "phi_mu_blocked")
    dense = ("dense_phi", "dense_phi_mu")
    _reset_counts()
    t0 = time.perf_counter()
    cold = svc.submit("dense-cut", base, RANK, seed=seed)
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    counted_solve("13.3 dense-cut tenant submit", cold.result, len(shape),
                  _launch_counts(), sparse, dense + ("dense_mttkrp",), total)
    _reset_counts()
    t0 = time.perf_counter()
    warm = svc.append("dense-cut", idx, vals)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    check(warm.stats_changed, "the append across the dense cut was not "
          "flagged as a stats move")
    counted_solve("13.3 dense-cut tenant warm append", warm.result,
                  len(shape), _launch_counts(), dense,
                  sparse + ("dense_mttkrp",), total)
    fills = [round(s.fill_frac, 4) for s in svc.tenant("dense-cut").mode_stats]
    print(f"13.3 dense-cut tenant: {base.nnz} -> "
          f"{svc.tenant('dense-cut').tensor.nnz} nonzeros of {cells} cells "
          f"(fill {fills}); submit {submit_s:.3f} s (solve "
          f"{cold.result.seconds:.3f} s), append {append_s:.3f} s (warm "
          f"solve {warm.result.seconds:.3f} s)")


def service_phase(t, truth, init, name: str, dev, seed: int) -> dict:
    """Phase 13: the decomposition service at real sizes; returns the
    kernel launches of its counted solves."""
    from repro_torch.kernels.dense import kernel as dense_kernel
    from repro_torch.serve.decomp import DecompService

    t0 = time.perf_counter()
    bucket_tier_part(dev, seed)
    print(f"13.1 bucket tier: {time.perf_counter() - t0:.1f} s")
    svc = DecompService(autotune_path=_work_path("service.json"), device=dev,
                        max_outer=MAX_OUTER, max_inner=MAX_INNER,
                        track_loglik=True)
    total: dict = {}
    t0 = time.perf_counter()
    large_tenant_part(svc, t, truth, init, name, dev, seed, total)
    print(f"13.2/13.4 large tenant: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_cut_part(svc, dev, seed, total)
    print(f"13.3 dense-cut tenant: {time.perf_counter() - t0:.1f} s")
    per_stream: dict = {}
    for key in dense_kernel._WORK:
        if key[0].type == "cuda":
            per_stream[key[:2]] = per_stream.get(key[:2], 0) + 1
    print(f"13.5 dense workspaces per stream {list(per_stream.values())} "
          f"(bound {dense_kernel.WORK_MAX}); service stats "
          f"{svc.stats()['autotune']}, {svc.stats()['tenants']} tenants")
    check(all(n <= dense_kernel.WORK_MAX for n in per_stream.values()),
          f"dense workspaces past their bound: {per_stream}")
    print(f"13 service launches (counted solves): {total}")
    return total


# ---------------------------------------------------------------------------
# Phase 14: the row-sharded multi-device tier
# ---------------------------------------------------------------------------


def _shard_modes(layouts) -> list:
    """The modes whose 256 x 256 layout has a row block for every shard
    of the largest count (uber: modes 2 and 3); the others fall back."""
    return [n for n, lay in enumerate(layouts)
            if lay.n_row_blocks >= max(SHARD_COUNTS)]


def sharded_kernel_phase(t, init, mvs, layouts, timing_iters: int) -> None:
    """14.1: B2 and B3 once per shard on per-shard windows (both combines,
    replicated and shard-local Π) against the same calls on the plain
    blocked schedule; exact launch counts; exact-zero padding rows; one
    sharded fused MU step per shard count as a CUDA-graph burst beside the
    unsharded ``cuda`` step."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.layout import (
        build_shard_pi_gather,
        owner_partition,
        pad_rows,
        shard_blocked_layout,
    )
    from repro_torch.core.phi import expand_to_layout, expand_to_shards, phi_mu_step
    from repro_torch.core.pi import pi_rows
    from repro_torch.kernels.mttkrp import ops as mttkrp_ops
    from repro_torch.kernels.phi import ops as phi_ops

    dev = t.device
    for n in _shard_modes(layouts):
        mv, lay = mvs[n], layouts[n]
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
        steps = {"unsharded cuda": graph_ms(
            lambda: phi_mu_step(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                strategy="cuda", layout=lay, vals_e=vals_e,
                                pi_e=pi_e, device=dev), timing_iters)}
        for s_count in SHARD_COUNTS:
            sl = shard_blocked_layout(lay, s_count)
            print(f"mode {n} at S={s_count}: row blocks per shard "
                  f"{sl.rb_count.tolist()} (padded to {sl.n_rb_shard}), nnz "
                  f"per shard {sl.shard_nnz.tolist()}, grid steps per shard "
                  f"{sl.n_grid_shard}, pad_fraction {sl.pad_fraction:.4f} "
                  f"(unsharded {lay.pad_fraction:.4f})")
            vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
            pig = build_shard_pi_gather(sl, mv.sorted_idx, n)
            worst = [0.0, 0.0]
            for combine in D.PHI_COMBINES:
                for local_pi in (False, True):
                    kw = dict(combine=combine)
                    if local_pi:
                        kw.update(pi_gather=pig, factors=init.factors)
                    phi_ops.reset_launch_counts()
                    mttkrp_ops.reset_launch_counts()
                    phi_k = D.phi_sharded(sl, vals_es, pi_es, b,
                                          local_strategy="cuda", **kw)
                    kr_k = D.krao_sharded(sl, vals_es, pi_es,
                                          local_strategy="cuda", **kw)
                    torch.cuda.synchronize()
                    counted = (dict(phi_ops.launch_counts),
                               dict(mttkrp_ops.launch_counts))
                    check(counted[0] == {"phi_blocked": s_count,
                                         "phi_mu_blocked": 0}
                          and counted[1]["mttkrp_blocked"] == s_count,
                          f"mode {n} S={s_count} {combine} local_pi="
                          f"{local_pi}: launches {counted}, expected "
                          f"{s_count} of B2 and of B3")
                    phi_p = D.phi_sharded(sl, vals_es, pi_es, b,
                                          local_strategy="blocked", **kw)
                    kr_p = D.krao_sharded(sl, vals_es, pi_es,
                                          local_strategy="blocked", **kw)
                    for i, e in enumerate((errors(phi_k, phi_p),
                                           errors(kr_k, kr_p))):
                        worst[i] = max(worst[i], e[0])
                        check(e[2], f"mode {n} S={s_count} {combine} "
                                    f"local_pi={local_pi}: the per-shard "
                                    f"{('B2', 'B3')[i]} result disagrees "
                                    f"with the blocked schedule")
            st = sl.on(dev)
            b_buf = pad_rows(b, sl.buf_rows)
            br, wr = sl.block_rows, sl.win_rows
            padded = 0
            for s in range(s_count):
                r0 = int(sl.rb_start[s]) * br
                real = int(sl.rb_count[s]) * br
                args = (vals_es[s], pi_es[s], st.local_rows[s], st.grid_rb[s])
                wins = (D._shard_window(sl, 1e-10, "cuda", *args,
                                        b_buf[r0:r0 + wr]),
                        D._shard_window(sl, 0.0, "cuda", *args, None))
                for w in wins:
                    check(bool((w[real:] == 0).all()),
                          f"mode {n} S={s_count} shard {s}: a padding row "
                          f"of the kernel's window is not exactly zero")
                padded += wr - real
            opart = owner_partition(sl)
            b_own = D.owner_stack(opart, b)
            steps[f"S={s_count} reduce_scatter"] = graph_ms(
                lambda: D.phi_mu_sharded_owner(sl, opart, vals_es, pi_es,
                                               b_own, local_strategy="cuda"),
                timing_iters)
            steps[f"S={s_count} psum"] = graph_ms(
                lambda: D.phi_mu_sharded(sl, vals_es, pi_es, b,
                                         local_strategy="cuda"),
                timing_iters)
            print(f"mode {n} S={s_count}: B2/B3 per shard vs blocked max abs "
                  f"err {worst[0]:.3e}/{worst[1]:.3e} (rtol {KERNEL_RTOL}, "
                  f"atol {KERNEL_ATOL}) ok over both combines with "
                  f"replicated and shard-local Π; launches {s_count} of "
                  f"each per call; {padded} padding rows over the shards, "
                  f"all exactly zero")
        print(f"mode {n} fused MU step, device ms per step in a CUDA graph "
              f"(graph_ms): " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in steps.items()))


def _per_update_launches(events, final) -> list:
    """(mode, strategy, B1, B2) launched by each mode update, from the
    counts the mode hook snapshotted before each one and the final ones."""
    out = []
    for i, (mode, strategy, counts) in enumerate(events):
        nxt = events[i + 1][2] if i + 1 < len(events) else final
        out.append((mode, strategy,
                    nxt["phi_mu_blocked"] - counts["phi_mu_blocked"],
                    nxt["phi_blocked"] - counts["phi_blocked"]))
    return out


def sharded_solve_phase(t, init, layouts, res, ref, dev):
    """14.2: the counted sharded CP-APR solve; returns it and its launch
    counts."""
    import warnings

    import torch

    from repro_torch.core import resilience
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.kernels.phi import ops

    cfg = _sharded_cfg()
    events: list = []

    def snapshot(ctx):
        events.append((ctx["mode"], ctx["strategy"], dict(ops.launch_counts)))

    resilience.register_mode_hook(snapshot)
    try:
        ops.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sh = cpapr_mu(t, RANK, init=init, device=dev, config=cfg)
        torch.cuda.synchronize()
        final = dict(ops.launch_counts)
    finally:
        resilience.unregister_mode_hook(snapshot)
    fell_back = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    shard_modes = _shard_modes(layouts)
    print(f"sharded solve (S={N_SHARDS}, cuda local kernels, combine auto, "
          f"shard_pi): {sh.n_outer} sweeps, inner iterations "
          f"{sh.inner_iters}, launches {final}; modes {shard_modes} "
          f"sharded, {len(fell_back)} fallback warnings: {fell_back}")
    print(f"  kkt {sh.kkt_history}")
    print(f"  loglik {sh.loglik_history}")
    print(f"  seconds per sweep {sh.sweep_seconds} (phase 3's unsharded "
          f"cuda {res.sweep_seconds})")
    check(sh.recoveries is None, f"sharded solve recoveries or demotions: "
                                 f"{sh.recoveries}")
    check(len(fell_back) == t.ndim - len(shard_modes),
          f"expected a fallback warning for each of the "
          f"{t.ndim - len(shard_modes)} unsharded modes: {fell_back}")
    # each sharded mode update: B2 once per shard for the scooch and once
    # per shard per inner iteration; each fallback mode: B2 once, B1 once
    # per inner iteration
    per = _per_update_launches(events, final)
    inner = []
    for mode, strategy, b1, b2 in per:
        if mode in shard_modes:
            check(strategy == "sharded" and b1 == 0 and b2 % N_SHARDS == 0
                  and b2 >= 2 * N_SHARDS,
                  f"sharded mode {mode} launched B1 {b1} and B2 {b2} times "
                  f"in one update: not {N_SHARDS} x (1 + inner)")
            inner.append(b2 // N_SHARDS - 1)
        else:
            check(strategy == "cuda" and b2 == 1 and b1 >= 1,
                  f"fallback mode {mode} launched B1 {b1} and B2 {b2} times "
                  f"in one update: not B2 once and B1 per inner iteration")
            inner.append(b1)
    sweeps = [sum(inner[k * t.ndim:(k + 1) * t.ndim])
              for k in range(sh.n_outer)]
    check(len(per) == sh.n_outer * t.ndim and sweeps == sh.inner_iters,
          f"launches imply inner counts {sweeps}, the solve reports "
          f"{sh.inner_iters}")
    ll = sh.loglik_history
    check(len(ll) == len(res.loglik_history) and all(math.isfinite(x)
                                                     for x in ll)
          and monotone(ll), f"sharded log-likelihood not finite and "
                            f"nondecreasing: {ll}")
    for other, label in ((res, "cuda"), (ref, "segment")):
        ll_err = max(abs(a - b) / abs(b)
                     for a, b in zip(ll, other.loglik_history))
        kkt_err = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(sh.kkt_history, other.kkt_history))
        print(f"sharded vs unsharded {label}: loglik max rel diff "
              f"{ll_err:.3e} (rtol {LOGLIK_RTOL}), kkt max rel diff "
              f"{kkt_err:.3e} (rtol {KKT_RTOL})")
        check(ll_err <= LOGLIK_RTOL and kkt_err <= KKT_RTOL,
              f"the sharded solve disagrees with the {label} solve")
    return sh, {"phi_blocked": final["phi_blocked"],
                "phi_mu_blocked": final["phi_mu_blocked"]}


def _sharded_cfg(**kw):
    """The phase's sharded CP-APR config: default_policy's 256 x 256
    blocking on the local cuda kernels, N_SHARDS emulated shards."""
    from repro_torch.core.cpapr import CPAPRConfig
    from repro_torch.core.policy import PhiPolicy

    base = dict(rank=RANK, max_outer=MAX_OUTER, max_inner=MAX_INNER,
                strategy="sharded", n_shards=N_SHARDS, combine="auto",
                shard_pi=True,
                policy=PhiPolicy(strategy="cuda", block_nnz=256,
                                 block_rows=256))
    base.update(kw)
    return CPAPRConfig(**base)


def sharded_als_phase(t, init, layouts, dev) -> int:
    """14.3: the counted sharded CP-ALS; returns its B3 launches."""
    import warnings

    from repro_torch.core.policy import PhiPolicy
    from repro_torch.kernels.mttkrp import ops

    kw = dict(n_shards=N_SHARDS,
              policy=PhiPolicy(strategy="cuda", block_nnz=256,
                               block_rows=256))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallback modes warn
        fits, spi, counted = timed_cp_als(t, init, "sharded", dev,
                                          counts=ops, **kw)
        ref_fits, ref_spi, _ = timed_cp_als(t, init, "segment", dev)
    launches = counted["mttkrp_blocked"]
    shard_modes = _shard_modes(layouts)
    want = ALS_ITERS * sum(N_SHARDS if n in shard_modes else 1
                           for n in range(t.ndim))
    print(f"cp_als sharded (S={N_SHARDS}, cuda local): fits {fits}, "
          f"{spi:.6f} s per iteration, mttkrp_blocked launches {launches} "
          f"(expected {want}: {N_SHARDS} per sharded mode {shard_modes} and "
          f"1 per fallback mode per iteration)")
    print(f"cp_als segment: fits {ref_fits}, {ref_spi:.6f} s per iteration")
    check(launches == want, f"mttkrp_blocked launched {launches} times, "
                            f"expected {want}")
    check(all(math.isfinite(f) for f in fits), f"non-finite fit: {fits}")
    fit_err = max(abs(a - b) for a, b in zip(fits, ref_fits))
    print(f"cp_als sharded vs segment: fit max abs diff {fit_err:.3e} "
          f"(atol {FIT_ATOL})")
    check(fit_err <= FIT_ATOL, "sharded CP-ALS fits disagree")
    return launches


def _ll_rel(a, b) -> float:
    return abs(a.loglik_history[-1] - b.loglik_history[-1]) / abs(
        b.loglik_history[-1])


def nccl_phase(t, init, dev) -> None:
    """14.4: the collective code path on a one-rank NCCL process group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.cpapr import cpapr_mu, poisson_loglik
    from repro_torch.core.distributed import (
        PHI_COMBINES,
        DistCPAPRConfig,
        dist_cpapr_mu,
        make_phi_mesh,
    )

    rdv = _work_path("nccl_rendezvous")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        mesh = make_phi_mesh(1)
        for combine in PHI_COMBINES:
            emu = cpapr_mu(t, RANK, init=init, device=dev,
                           config=_sharded_cfg(n_shards=1, combine=combine))
            got = cpapr_mu(t, RANK, init=init, device=dev,
                           config=_sharded_cfg(n_shards=None, mesh=mesh,
                                               combine=combine))
            err = _ll_rel(got, emu)
            print(f"one-rank NCCL mesh, {combine}: inner iterations "
                  f"{got.inner_iters} (emulated {emu.inner_iters}), final "
                  f"loglik {got.loglik_history[-1]} (emulated "
                  f"{emu.loglik_history[-1]}, rel diff {err:.3e}, rtol "
                  f"{LOGLIK_RTOL}), seconds per sweep {got.sweep_seconds}")
            check(got.recoveries is None and err <= LOGLIK_RTOL,
                  f"the NCCL-mesh {combine} solve disagrees with the "
                  f"emulated one-shard solve")
        dmesh = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        kt_d, hist = dist_cpapr_mu(
            t, RANK, dmesh, init=init, device=dev,
            config=DistCPAPRConfig(rank=RANK, max_outer=MAX_OUTER,
                                   max_inner=MAX_INNER))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ll_d = float(poisson_loglik(t, kt_d))
        err = abs(ll_d - emu.loglik_history[-1]) / abs(emu.loglik_history[-1])
        kkt_err = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(hist, emu.kkt_history))
        print(f"dist_cpapr_mu on a (1, 1) data x model NCCL mesh: "
              f"{len(hist)} sweeps in {secs:.2f} s, kkt {hist}, final loglik "
              f"{ll_d} (emulated one-shard {emu.loglik_history[-1]}, rel "
              f"diff {err:.3e}, rtol {LOGLIK_RTOL}; kkt max rel diff "
              f"{kkt_err:.3e}, rtol {KKT_RTOL})")
        check(len(hist) == len(emu.kkt_history) and err <= LOGLIK_RTOL
              and kkt_err <= KKT_RTOL,
              "dist_cpapr_mu disagrees with the emulated one-shard solve")
    finally:
        dist.destroy_process_group()


def sharded_ladder_phase(t, init, layouts, sh, dev, seed: int) -> None:
    """14.5: the multi-device rungs with the ladder on, a killed and
    resumed sharded uber solve, and rebalancing."""
    import warnings

    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.testing import faults

    # 14.2 checked the fallback warnings of the unsharded modes
    warnings.filterwarnings("ignore", message="sharded CP-APR mode")
    m_oom, m_fp = _shard_modes(layouts)[:2]
    runs = {
        "oom": (dict(max_demotions=4),
                lambda: faults.fail_oom(mode=m_oom, min_shards=2, times=1),
                [("demote_oom", m_oom, f"shards {N_SHARDS}->"
                                       f"{N_SHARDS // 2}")]),
        "fingerprint": (dict(max_demotions=4, combine="reduce_scatter"),
                        lambda: faults.fail_fingerprint(mode=m_fp),
                        [("demote_fingerprint", m_fp,
                          "combine reduce_scatter->psum")]),
    }
    for label, (kw, fault, want) in runs.items():
        with fault() as budget:
            r = cpapr_mu(t, RANK, init=init, device=dev,
                         config=_sharded_cfg(**kw))
        rec = [(e.kind, e.mode, e.detail.get("action"))
               for e in r.recoveries or []]
        err = _ll_rel(r, sh)
        print(f"injected {label} fault on a sharded mode: recoveries {rec}, "
              f"inner iterations {r.inner_iters}, final loglik rel diff from "
              f"the clean sharded solve {err:.3e} (rtol {LOGLIK_RTOL})")
        check(budget == [0] and rec == want,
              f"the {label} fault was not demoted as {want}: {rec}")
        check(err <= LOGLIK_RTOL, f"the {label}-demoted solve disagrees")
    ck = _work_path("uber_sharded.ckpt")
    resumed = _killed_then_resumed(
        t, _sharded_cfg(checkpoint_every=1, checkpoint_path=ck), dev,
        init=init)
    err = _ll_rel(resumed, sh)
    print(f"sharded uber solve killed at sweep {KILL_AT} and resumed: inner "
          f"iterations {resumed.inner_iters} (uninterrupted "
          f"{sh.inner_iters}), final loglik rel diff {err:.3e} (rtol "
          f"{LOGLIK_RTOL})")
    check(resumed.inner_iters == sh.inner_iters and err <= LOGLIK_RTOL,
          "the resumed sharded solve disagrees with the uninterrupted one")
    skewed_rebalance_part(dev, seed)


def skewed_rebalance_part(dev, seed: int) -> None:
    """14.5, rebalancing: uber's row blocks carry even nonzero counts, so
    its step-balanced split is already nnz-balanced and nothing moves.
    A tensor whose mode-0 row blocks are skewed (SKEW_SPARSE row blocks
    with 2 nonzeros, 4 with SKEW_DENSE: the step-balanced split gives one
    shard the sparse blocks and almost no nonzeros) is rebalanced with
    ``rebalance_every=1`` on 2 shards (local cuda kernels, 64 x 8
    blocking): the events must be the modes whose nnz-weighted split
    differs from the step split, the result within LOGLIK_RTOL of the
    static split, and the same solve killed and resumed (its checkpoint
    holds the rebalanced cuts) within LOGLIK_RTOL with equal inner counts
    and rebalances."""
    import numpy as np

    from repro_torch.core.convert import sparse_tensor_from_numpy
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.core.layout import (
        build_blocked_layout,
        rebalance_shards,
        shard_blocked_layout,
    )
    from repro_torch.core.policy import PhiPolicy
    from repro_torch.core.sparse_tensor import random_ktensor, sort_mode

    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        np.repeat(np.arange(SKEW_SPARSE) * 8, 2),
        np.repeat((SKEW_SPARSE + np.arange(4)) * 8, SKEW_DENSE)])
    shape = ((SKEW_SPARSE + 4) * 8,) + SKEW_OTHER
    idx = np.stack([rows] + [rng.integers(0, d, rows.size)
                             for d in SKEW_OTHER], 1)
    vals = rng.poisson(2.0, rows.size).astype(np.float32) + 1.0
    st = sparse_tensor_from_numpy(shape, idx, vals, device=dev)
    sinit = random_ktensor(shape, RANK, seed=seed, device=dev).normalize()
    pol = PhiPolicy(strategy="cuda", block_nnz=64, block_rows=8)
    kw = dict(n_shards=2, policy=pol)
    moved = []
    for n in range(st.ndim):
        sl = shard_blocked_layout(build_blocked_layout(
            sort_mode(st, n).rows.cpu().numpy(), shape[n], 64, 8), 2)
        if not np.array_equal(rebalance_shards(sl).rb_start, sl.rb_start):
            moved.append(n)
    static = cpapr_mu(st, RANK, init=sinit, device=dev,
                      config=_sharded_cfg(**kw))
    reb = cpapr_mu(st, RANK, init=sinit, device=dev,
                   config=_sharded_cfg(rebalance_every=1, **kw))
    events = reb.rebalances or []
    err = _ll_rel(reb, static)
    print(f"skewed tensor {shape}, nnz {st.nnz}: rebalance_every=1 events "
          f"{[(e['outer'], e['mode'], e['rb_start_old'], e['rb_start_new'], e['imbalance_old'], e['imbalance_new']) for e in events]}; "
          f"modes whose nnz split differs from the step split {moved}; "
          f"final loglik rel diff from the static split {err:.3e} (rtol "
          f"{LOGLIK_RTOL}); seconds per sweep {reb.sweep_seconds} (static "
          f"{static.sweep_seconds})")
    check(moved and sorted({e["mode"] for e in events}) == moved
          and all(e["imbalance_new"] < e["imbalance_old"] for e in events)
          and reb.recoveries is None and err <= LOGLIK_RTOL,
          "the rebalanced solve did not record its re-splits or disagrees")
    ck = _work_path("skewed_sharded.ckpt")
    resumed = _killed_then_resumed(
        st, _sharded_cfg(rebalance_every=1, checkpoint_every=1,
                         checkpoint_path=ck, **kw), dev, init=sinit)
    err = _ll_rel(resumed, reb)
    print(f"rebalanced skewed solve killed at sweep {KILL_AT} and resumed: "
          f"inner iterations {resumed.inner_iters} (uninterrupted "
          f"{reb.inner_iters}), rebalances equal "
          f"{resumed.rebalances == reb.rebalances}, final loglik rel diff "
          f"{err:.3e} (rtol {LOGLIK_RTOL})")
    check(resumed.inner_iters == reb.inner_iters and err <= LOGLIK_RTOL
          and resumed.rebalances == reb.rebalances,
          "the resumed rebalanced solve disagrees with the uninterrupted one")


def sharded_phase(t, init, mvs, layouts, res, ref, dev, seed: int,
                  timing_iters: int) -> tuple:
    """Phase 14; returns the launch counts of its counted solves and its
    counted CP-APR solve."""
    t0 = time.perf_counter()
    sharded_kernel_phase(t, init, mvs, layouts, timing_iters)
    print(f"14.1 kernels per shard: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sh, launches = sharded_solve_phase(t, init, layouts, res, ref, dev)
    print(f"14.2 sharded CP-APR: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["mttkrp_blocked"] = sharded_als_phase(t, init, layouts, dev)
    print(f"14.3 sharded CP-ALS: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nccl_phase(t, init, dev)
    print(f"14.4 one-rank NCCL mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_ladder_phase(t, init, layouts, sh, dev, seed)
    print(f"14.5 ladder, rebalance, resume: {time.perf_counter() - t0:.1f} s")
    return launches, sh


# ---------------------------------------------------------------------------
# Phase 15: the N-D device-grid tier
# ---------------------------------------------------------------------------


def _grid_shapes(mv, lay) -> list:
    """15.1's grid shapes of one mode: the explicit GRID_EXPLICIT one and
    the one :func:`choose_grid_shape` picks at N_SHARDS from the mode's
    skew at the layout's blocking (once where they are equal)."""
    from repro_torch.core.layout import choose_grid_shape, mode_run_stats

    chosen = choose_grid_shape(
        mv.n_rows, lay.block_rows, RANK, N_SHARDS,
        stats=mode_run_stats(mv.rows.cpu().numpy(), mv.n_rows))
    explicit = GRID_EXPLICIT[mv.mode]
    return [("explicit", explicit)] + (
        [] if chosen == explicit else [("chosen", chosen)])


def _grid_padding_zero(g, vals_cs, pi_cs, b) -> int:
    """Every cell's B2 and B3 window (the kernels' own output) is exactly
    zero past its shard's real rows, and the grid-stacked B is zero on
    every masked row; returns the padding rows checked."""
    import torch

    from repro_torch.core import distributed as D

    st = g.on(b.device)
    b_own = D.grid_stack(g, b)
    check(bool((b_own[~g.masks_on(b.device)[0]] == 0).all()),
          f"grid {g.grid_a}x{g.grid_b}: a masked row of the grid-stacked B "
          f"is not zero")
    own = g.slayout.n_rb_shard * g.block_rows
    padded = 0
    for f in range(g.n_shards):
        s = f // g.grid_b
        b_win = b_own[s * g.grid_b:(s + 1) * g.grid_b].reshape(
            g.own_rows_pad, -1)[:own]
        real = int(g.slayout.rb_count[s]) * g.block_rows
        args = (vals_cs[f], pi_cs[f], st.local_rows[f], st.grid_rb[f])
        for w in (D._shard_window(g.slayout, 1e-10, "cuda", *args, b_win),
                  D._shard_window(g.slayout, 0.0, "cuda", *args, None)):
            check(bool((w[real:] == 0).all()),
                  f"grid {g.grid_a}x{g.grid_b} cell {f}: a padding row of "
                  f"the kernel's window is not exactly zero")
        padded += own - real
    torch.cuda.synchronize()
    return padded


def grid_kernel_phase(t, init, mvs, layouts, timing_iters: int) -> None:
    """15.1: B2/B3 once per grid cell, against the plain blocked cells;
    exact launch counts; exact-zero padding; one grid fused MU step per
    shape as a CUDA-graph burst beside the unsharded ``cuda`` step and
    the S = N_SHARDS 1-D step."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.layout import (
        build_grid_layout,
        owner_partition,
        shard_blocked_layout,
    )
    from repro_torch.core.phi import (
        expand_to_grid,
        expand_to_layout,
        expand_to_shards,
        phi_mu_step,
    )
    from repro_torch.core.pi import pi_rows
    from repro_torch.kernels.mttkrp import ops as mttkrp_ops
    from repro_torch.kernels.phi import ops as phi_ops

    dev = t.device
    for n, (mv, lay) in enumerate(zip(mvs, layouts)):
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
        steps = {"unsharded cuda": graph_ms(
            lambda: phi_mu_step(mv.rows, mv.sorted_vals, pi, b, mv.n_rows,
                                strategy="cuda", layout=lay, vals_e=vals_e,
                                pi_e=pi_e, device=dev), timing_iters)}
        if lay.n_row_blocks >= N_SHARDS:
            sl = shard_blocked_layout(lay, N_SHARDS)
            opart = owner_partition(sl)
            vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
            b_own1 = D.owner_stack(opart, b)
            steps[f"1-D S={N_SHARDS}"] = graph_ms(
                lambda: D.phi_mu_sharded_owner(sl, opart, vals_es, pi_es,
                                               b_own1, local_strategy="cuda"),
                timing_iters)
        else:
            steps[f"1-D S={N_SHARDS}"] = None  # falls back: one row block
        for label, shape in _grid_shapes(mv, lay):
            a, bc = shape
            g = build_grid_layout(lay, shape)
            vals_cs, pi_cs = expand_to_grid(g, mv.sorted_vals, pi)
            want = {"B2": {"phi_blocked": a * bc, "phi_mu_blocked": 0},
                    "B3": {"mttkrp_blocked": a * bc}}
            calls = {
                "phi_grid": ("B2", lambda loc: D.phi_grid(
                    g, vals_cs, pi_cs, b, local_strategy=loc)),
                "krao_grid": ("B3", lambda loc: D.krao_grid(
                    g, vals_cs, pi_cs, local_strategy=loc)),
                "phi_mu_grid": ("B2", lambda loc: D.phi_mu_grid(
                    g, vals_cs, pi_cs, b, local_strategy=loc)),
            }
            worst = {}
            for name, (kern, call) in calls.items():
                phi_ops.reset_launch_counts()
                mttkrp_ops.reset_launch_counts()
                got = call("cuda")
                torch.cuda.synchronize()
                counted = (dict(phi_ops.launch_counts) if kern == "B2"
                           else {"mttkrp_blocked":
                                 mttkrp_ops.launch_counts["mttkrp_blocked"]})
                check(counted == want[kern],
                      f"mode {n} grid {a}x{bc} {name}: launches {counted}, "
                      f"expected {want[kern]} (A*B = {a * bc})")
                plain = call("blocked")
                if name == "phi_mu_grid":
                    e_v = errors(got[1].reshape(1), plain[1].reshape(1))
                    check(e_v[2], f"mode {n} grid {a}x{bc}: the fused "
                                  f"step's KKT value disagrees")
                    got, plain = got[0], plain[0]
                e = errors(got, plain)
                worst[name] = e[0]
                check(e[2], f"mode {n} grid {a}x{bc} {name}: the per-cell "
                            f"{kern} result disagrees with the blocked cells")
            padded = _grid_padding_zero(g, vals_cs, pi_cs, b)
            b_own = D.grid_stack(g, b)
            steps[f"grid {a}x{bc} ({label})"] = graph_ms(
                lambda: D.phi_mu_grid_owner(g, vals_cs, pi_cs, b_own,
                                            local_strategy="cuda"),
                timing_iters)
            print(f"mode {n} grid {a}x{bc} ({label}): cells "
                  f"{g.n_shards}, nnz per cell {g.cell_nnz.tolist()}, grid "
                  f"steps per cell {g.n_grid_cell}, pad_fraction "
                  f"{g.pad_fraction:.4f} (unsharded {lay.pad_fraction:.4f}), "
                  f"sub_rows {g.sub_rows}, grid_scatter_wire_bytes "
                  f"{D.grid_scatter_wire_bytes(g, RANK):.0f} (1-D owner "
                  f"scatter at S={N_SHARDS}: "
                  f"{_owner_wire(lay, N_SHARDS):.0f}); B2/B3 per cell vs "
                  f"blocked max abs err "
                  + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                  + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) ok; launches "
                  f"{a * bc} per call; {padded} padding rows over the cells, "
                  f"all exactly zero")
        print(f"mode {n} fused MU step, device ms per step in a CUDA graph "
              f"(graph_ms): " + ", ".join(
                  f"{k} " + ("n/a (fewer row blocks than shards)" if v is None
                             else f"{v:.4f} ms") for k, v in steps.items()))


def _owner_wire(lay, s_count: int) -> float:
    """The 1-D reduce-scatter's wire bytes at ``s_count`` shards, or nan
    where the mode has fewer row blocks than shards."""
    from repro_torch.core import distributed as D
    from repro_torch.core.layout import owner_partition, shard_blocked_layout

    if lay.n_row_blocks < s_count:
        return float("nan")
    return D.owner_scatter_wire_bytes(
        owner_partition(shard_blocked_layout(lay, s_count)), RANK)


def _grid_cfg(**kw):
    """Phase 15's grid CP-APR config: default_policy's 256 x 256 blocking
    on the local cuda kernels, N_SHARDS emulated cells."""
    from repro_torch.core.cpapr import CPAPRConfig
    from repro_torch.core.policy import PhiPolicy

    base = dict(rank=RANK, max_outer=MAX_OUTER, max_inner=MAX_INNER,
                strategy="grid", n_shards=N_SHARDS,
                policy=PhiPolicy(strategy="cuda", block_nnz=256,
                                 block_rows=256))
    base.update(kw)
    return CPAPRConfig(**base)


def grid_solve_phase(t, init, res, ref, sh, grid_shape, dev):
    """15.2: one counted grid CP-APR solve; returns it and its launches.

    A mode hook snapshots the launch counts and the mode's grid before
    every mode update: each grid update must launch B2 A*B x (1 + inner)
    times and B1 never, each fallback update (a mode with fewer row
    blocks than the grid's row axis warns and runs unsharded) B2 once
    and B1 per inner iteration, and the implied inner counts must be the
    solve's own."""
    import warnings

    import torch

    from repro_torch.core import resilience
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.kernels.phi import ops

    events: list = []
    grids: dict = {}

    def snapshot(ctx):
        events.append((ctx["mode"], ctx["strategy"], dict(ops.launch_counts)))
        grids[ctx["mode"]] = ctx.get("grid")

    resilience.register_mode_hook(snapshot)
    try:
        ops.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gr = cpapr_mu(t, RANK, init=init, device=dev,
                          config=_grid_cfg(grid_shape=grid_shape))
        torch.cuda.synchronize()
        final = dict(ops.launch_counts)
    finally:
        resilience.unregister_mode_hook(snapshot)
    fell_back = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    label = f"grid_shape={grid_shape}"
    print(f"grid solve ({label}, S={N_SHARDS}, cuda local kernels): "
          f"{gr.n_outer} sweeps, inner iterations {gr.inner_iters}, "
          f"launches {final}; per-mode grids {grids}; "
          f"{len(fell_back)} fallback warnings: {fell_back}")
    print(f"  kkt {gr.kkt_history}")
    print(f"  loglik {gr.loglik_history}")
    print(f"  seconds per sweep {gr.sweep_seconds} (phase 3's unsharded "
          f"cuda {res.sweep_seconds}; phase 14's S={N_SHARDS} "
          f"{sh.sweep_seconds})")
    check(gr.recoveries is None, f"grid solve ({label}) recoveries or "
                                 f"demotions: {gr.recoveries}")
    n_fallback = sum(1 for g in grids.values() if g is None)
    check(len(fell_back) == n_fallback,
          f"{n_fallback} modes run unsharded but {len(fell_back)} warned")
    per = _per_update_launches(events, final)
    inner = []
    for mode, strategy, b1, b2 in per:
        g = grids[mode]
        if g is not None:
            cells = g[0] * g[1]
            check(strategy == "grid" and b1 == 0 and b2 % cells == 0
                  and b2 >= 2 * cells,
                  f"grid mode {mode} {g} launched B1 {b1} and B2 {b2} times "
                  f"in one update: not {cells} x (1 + inner) and no B1")
            inner.append(b2 // cells - 1)
        else:
            check(strategy == "cuda" and b2 == 1 and b1 >= 1,
                  f"fallback mode {mode} launched B1 {b1} and B2 {b2} times "
                  f"in one update: not B2 once and B1 per inner iteration")
            inner.append(b1)
    sweeps = [sum(inner[k * t.ndim:(k + 1) * t.ndim])
              for k in range(gr.n_outer)]
    check(len(per) == gr.n_outer * t.ndim and sweeps == gr.inner_iters,
          f"launches imply inner counts {sweeps}, the solve reports "
          f"{gr.inner_iters}")
    ll = gr.loglik_history
    check(len(ll) == len(res.loglik_history) and monotone(ll)
          and all(math.isfinite(x) for x in ll),
          f"grid log-likelihood not finite and nondecreasing: {ll}")
    for other, name in ((res, "cuda"), (ref, "segment")):
        ll_err = max(abs(a - b) / abs(b)
                     for a, b in zip(ll, other.loglik_history))
        kkt_err = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(gr.kkt_history, other.kkt_history))
        print(f"grid ({label}) vs unsharded {name}: loglik max rel diff "
              f"{ll_err:.3e} (rtol {LOGLIK_RTOL}), kkt max rel diff "
              f"{kkt_err:.3e} (rtol {KKT_RTOL})")
        check(ll_err <= LOGLIK_RTOL and kkt_err <= KKT_RTOL,
              f"the grid solve ({label}) disagrees with the {name} solve")
    return gr, {"phi_blocked": final["phi_blocked"],
                "phi_mu_blocked": final["phi_mu_blocked"]}


def grid_als_phase(t, init, dev) -> int:
    """15.3: the counted grid CP-ALS (each mode's grid from
    choose_grid_shape, as in the JAX package's ``cp_als``); returns its
    B3 launches."""
    import warnings

    from repro_torch.core import resilience
    from repro_torch.core.policy import PhiPolicy
    from repro_torch.kernels.mttkrp import ops

    cells: dict = {}

    def grids(ctx):
        cells[ctx["mode"]] = ctx["n_shards"] if ctx["strategy"] == "grid" \
            else 1

    kw = dict(n_shards=N_SHARDS,
              policy=PhiPolicy(strategy="cuda", block_nnz=256,
                               block_rows=256))
    resilience.register_mode_hook(grids)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the fallback modes warn
            fits, spi, counted = timed_cp_als(t, init, "grid", dev,
                                              counts=ops, **kw)
    finally:
        resilience.unregister_mode_hook(grids)
    ref_fits, ref_spi, _ = timed_cp_als(t, init, "segment", dev)
    launches = counted["mttkrp_blocked"]
    want = ALS_ITERS * sum(cells[n] for n in range(t.ndim))
    print(f"cp_als grid (S={N_SHARDS}, cuda local): fits {fits}, "
          f"{spi:.6f} s per iteration, mttkrp_blocked launches {launches} "
          f"(expected {want}: A*B per grid mode, 1 per fallback mode, per "
          f"iteration; cells per mode {cells})")
    print(f"cp_als segment: fits {ref_fits}, {ref_spi:.6f} s per iteration")
    check(launches == want, f"mttkrp_blocked launched {launches} times, "
                            f"expected {want}")
    check(all(math.isfinite(f) for f in fits), f"non-finite fit: {fits}")
    fit_err = max(abs(a - b) for a, b in zip(fits, ref_fits))
    print(f"cp_als grid vs segment: fit max abs diff {fit_err:.3e} "
          f"(atol {FIT_ATOL})")
    check(fit_err <= FIT_ATOL, "grid CP-ALS fits disagree")
    return launches


def grid_nccl_phase(t, init, dev) -> None:
    """15.4: a (1, 1) grid on a one-rank NCCL process group against the
    emulated 1 x 1 grid solve."""
    import torch.distributed as dist

    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.core.distributed import make_grid_mesh

    rdv = _work_path("nccl_grid_rendezvous")
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        mesh = make_grid_mesh(1, 1)
        emu = cpapr_mu(t, RANK, init=init, device=dev,
                       config=_grid_cfg(n_shards=1, grid_shape=(1, 1)))
        got = cpapr_mu(t, RANK, init=init, device=dev,
                       config=_grid_cfg(n_shards=None, grid_shape=(1, 1),
                                        mesh=mesh))
        err = _ll_rel(got, emu)
        print(f"one-rank NCCL (1, 1) grid mesh: inner iterations "
              f"{got.inner_iters} (emulated {emu.inner_iters}), final loglik "
              f"{got.loglik_history[-1]} (emulated {emu.loglik_history[-1]}, "
              f"rel diff {err:.3e}, rtol {LOGLIK_RTOL}), seconds per sweep "
              f"{got.sweep_seconds}")
        check(got.recoveries is None and emu.recoveries is None
              and err <= LOGLIK_RTOL,
              "the NCCL grid-mesh solve disagrees with the emulated one")
    finally:
        dist.destroy_process_group()


def grid_ladder_phase(t, init, gr, dev) -> None:
    """15.5: the grid rungs with the ladder on, and a killed and resumed
    grid solve."""
    import warnings

    from repro_torch.core import resilience
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.testing import faults

    warnings.filterwarnings("ignore", message="grid CP-APR mode")
    runs = {
        "oom": (lambda: faults.fail_oom(mode=2, min_shards=3, times=1),
                [("demote_oom", 2, "grid 2x2->sharded@2")]),
        "kernel": (lambda: faults.fail_strategy(strategy="grid", mode=3,
                                                times=2),
                   [("demote_kernel", 3, "local cuda->blocked"),
                    ("demote_kernel", 3, "grid 2x2->sharded@2")]),
    }
    clean = cpapr_mu(t, RANK, init=init, device=dev,
                     config=_grid_cfg(grid_shape=(2, 2)))
    for label, (fault, want) in runs.items():
        with fault() as budget:
            r = cpapr_mu(t, RANK, init=init, device=dev,
                         config=_grid_cfg(grid_shape=(2, 2),
                                          max_demotions=4))
        rec = [(e.kind, e.mode, e.detail.get("action"))
               for e in r.recoveries or []]
        err = _ll_rel(r, clean)
        print(f"injected {label} fault on a 2x2 grid mode: recoveries {rec}, "
              f"inner iterations {r.inner_iters}, final loglik rel diff from "
              f"the clean 2x2 solve {err:.3e} (rtol {LOGLIK_RTOL})")
        check(budget == [0] and rec == want,
              f"the {label} fault did not take the grid rung as {want}: "
              f"{rec}")
        check(err <= LOGLIK_RTOL, f"the {label}-demoted solve disagrees")
    ck = _work_path("uber_grid.ckpt")
    cfg = _grid_cfg(grid_shape=(1, 4), checkpoint_every=1,
                    checkpoint_path=ck)
    resumed = _killed_then_resumed(t, cfg, dev, init=init)
    grids = resilience.load_checkpoint(ck)["mode_grids"]
    err = _ll_rel(resumed, gr)
    print(f"1x4 grid uber solve killed at sweep {KILL_AT} and resumed: inner "
          f"iterations {resumed.inner_iters} (uninterrupted "
          f"{gr.inner_iters}), checkpointed mode_grids {grids}, final loglik "
          f"rel diff {err:.3e} (rtol {LOGLIK_RTOL})")
    check(resumed.inner_iters == gr.inner_iters and err <= LOGLIK_RTOL
          and grids == [[1, 4]] * t.ndim,
          "the resumed grid solve disagrees with the uninterrupted one")


def grid_phase(t, init, mvs, layouts, res, ref, sh, dev,
               timing_iters: int) -> dict:
    """Phase 15; returns the launch counts of its counted solves."""
    t0 = time.perf_counter()
    grid_kernel_phase(t, init, mvs, layouts, timing_iters)
    print(f"15.1 kernels per grid cell: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches: dict = {}
    solves = {}
    for grid_shape in (None, (1, 4)):
        gr, counted = grid_solve_phase(t, init, res, ref, sh, grid_shape,
                                       dev)
        solves[grid_shape] = gr
        for k, v in counted.items():
            launches[k] = launches.get(k, 0) + v
    print(f"15.2 grid CP-APR: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["mttkrp_blocked"] = grid_als_phase(t, init, dev)
    print(f"15.3 grid CP-ALS: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_nccl_phase(t, init, dev)
    print(f"15.4 one-rank NCCL grid mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_ladder_phase(t, init, solves[(1, 4)], dev)
    print(f"15.5 grid ladder, resume: {time.perf_counter() - t0:.1f} s")
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
    t, truth = make_tensor(args.tensor, scale=args.scale, rank=RANK,
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
    check(res.recoveries is None,
          f"guard recoveries or demotions: {res.recoveries}")
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
    _, grid_best = grid_search_phase(init, mvs, dev, TIMING_ITERS)
    print(f"phase 9 (grid search): {time.perf_counter() - t0:.1f} s")

    # --- phase 11: the degradation ladder, checkpoints and resume ---------
    t0 = time.perf_counter()
    ladder_phase(t, res, dt, dinit, dev, args.seed)
    print(f"phase 11 (ladder, resume): {time.perf_counter() - t0:.1f} s")

    # --- phase 12: the autotuner on the full-width tensor ------------------
    t0 = time.perf_counter()
    autotune_phase(t, init, mvs, res, grid_best, dev, args.seed)
    print(f"phase 12 (autotune): {time.perf_counter() - t0:.1f} s")

    # --- phase 13: the decomposition service -------------------------------
    t0 = time.perf_counter()
    service_launches = service_phase(t, truth, init, args.tensor, dev,
                                     args.seed)
    print(f"phase 13 (service): {time.perf_counter() - t0:.1f} s")

    # --- phase 14: the row-sharded multi-device tier ------------------------
    t0 = time.perf_counter()
    sharded_launches, sh = sharded_phase(t, init, mvs, layouts, res, ref,
                                         dev, args.seed, TIMING_ITERS)
    print(f"phase 14 (sharded tier): {time.perf_counter() - t0:.1f} s")

    # --- phase 15: the N-D device-grid tier --------------------------------
    t0 = time.perf_counter()
    grid_launches = grid_phase(t, init, mvs, layouts, res, ref, sh, dev,
                               TIMING_ITERS)
    print(f"phase 15 (grid tier): {time.perf_counter() - t0:.1f} s")

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
         "service_launches": service_launches.get(k, 0),
         "sharded_launches": sharded_launches.get(k, 0),
         "grid_launches": grid_launches.get(k, 0),
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
