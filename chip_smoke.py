#!/usr/bin/env python3
"""Drive the PyTorch port's CP-APR, CP-ALS and LM paths on one NVIDIA card.

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
   bitwise equal from call to call); the operands each wrapper hands its
   kernel's launcher must total ``perf.comm.dense_input_bytes`` (unpadded:
   the port pads nothing), and the kernels' bound is computed from those
   bytes; then
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
    solve keeps them.  (6) The communication model (``perf.comm``, the
    JAX package's ``perf/hlo.py``) on each sharded mode at S = 2 and 4:
    the psum and reduce-scatter wire per device from the layouts,
    ``preferred_combine`` against them, ``phi_combine_wire_bound`` (held
    on every mode), ``phi_reduce_scatter_wire_bound`` (held where the
    owner windows stay within 2x the mean; the ratio printed),
    ``mttkrp_comm_lower_bound``; every shard's shard-local Π inputs
    within ``pi_gather_wire_bound`` beside ``pi_replicated_gather_bytes``
    and the share of rows touched; a projection (not a measurement) of
    the S = N_SHARDS wire over NVLink's 450 GB/s beside (1)'s fused
    steps; and (4)'s one-rank NCCL group under
    ``record_collectives``: one fused owner step records one
    reduce-scatter and no all-gather, one psum Φ (f32, and on bf16
    inputs) one all-reduce, each of the model's bytes and no wire.
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
    counts and its checkpoint's ``mode_grids``.  (6) For the explicit and
    the chosen grid of every mode: ``grid_scatter_wire_bytes`` equals
    ``grid_combine_wire_bound``, is at or above
    ``mttkrp_comm_lower_bound`` where the grid has a column axis, and
    below the S = N_SHARDS 1-D owner wire on grids of two or more rows
    (1 x B grids printed only); (4)'s (1, 1) grid recorded one fused
    step with no column collective.
16. LM serving (run after phase 15): the LM stack's serving path, which
    reaches no kernel of this port (the reference computes it with plain
    einsums, so the port does too; TF32 stays off).  (1) Every one of
    the ten architectures at full width in bf16, served through
    ``Engine.generate`` (greedy) with the reference launcher's defaults:
    batch LM_BATCH, prompt LM_PROMPT positions (pixtral's 1024 stub
    patches come before its LM_PROMPT text tokens), LM_NEW new tokens,
    weights and batch drawn from ``--seed``.  Full depth, except the two
    MoE giants at LM_DEPTH_CUT layers (qwen3: two MoE layers, 10 GiB of
    experts; llama4: one dense + one MoE sublayer, 32 GiB of experts).
    Checks: tokens (LM_BATCH, LM_NEW) in [0, vocab_pad), every prefill
    and decode logit finite, exactly LM_NEW - 1 ``decode_step`` calls
    (counted by a wrapper).  Printed: prefill ms and decode ms per step
    (CUDA events, median), tokens/s of a warm ``generate``, weight and
    cache bytes, peak memory and the decode step's byte bound (the
    weights it reads plus every cache byte, over HBM_BYTES_PER_S).
    (2) Decode against teacher forcing at full width in f32 for the four
    cache families (TF_ARCHS): prefill 8, decode 4 against the
    ``forward`` logits at TF_RTOL/TF_ATOL, as the reference's test.
    (3) The card against the CPU: the ten reduced f32 configs with the
    same weights on both, prefill plus three decode steps fed the CPU's
    greedy tokens, at CPU_RTOL/CPU_ATOL; and olmo-1b's first-token
    logits in bf16 against f32 of the same weights, within BF16_FRAC of
    the largest |logit|.  (4) ``repro_torch.launch.serve.main(["--arch",
    "olmo-1b", "--full"])`` returns 0.  No kernel's launch count moves
    in phase 16.  (5) Where olmo-1b's decode step goes: wall ms per step
    beside the device-busy ms torch.profiler records (the idle share)
    and the device kernels per step; it runs after phase 17, with 17.3.
17. LM training on one device (run after phase 16), which reaches no
    kernel of this port either (TF32 off).  (1) ``launch.train.main``
    at full width: olmo-1b, bf16, AdamW, 6 steps with a checkpoint every
    3, then the same command with ``--steps 8``, which resumes at step 6
    and ends at step 8 (the checkpoints, ~11 GiB each, go under
    ``build/chip_smoke/`` and are removed).  (2) The timed step: olmo-1b
    at full width, bf16, AdamW, batch TRAIN_BATCH x seq TRAIN_SEQ, remat
    per layer as its config says; after TRAIN_WARMUP steps, the median of
    TRAIN_TIMED by CUDA events and by the host clock, the loss and its
    gradient alone, tokens/s, peak memory, state bytes and MFU: 6 N T
    over the step's seconds times BF16_TENSOR_FLOPS (remat's recomputed
    forward is not counted: MFU counts the model's FLOPs).  (3) Last,
    with 16.5, where that step goes: wall ms beside torch.profiler's
    device-busy ms, the idle share and the device kernels per step.
    (4) One full-width bf16 step each of mamba2-1.3b and whisper-medium
    (ms, loss finite, peak); the others' state bytes (parameters,
    optimizer state, f32 gradients) against the card's 80 GiB.  (5) The
    ten reduced f32 configs on the card: the same batch stepped twice
    lowers a finite loss; one step against the CPU's from the same
    weights and batch, loss, grad norm and every state leaf within
    CPU_RTOL/CPU_ATOL (the rounding-sensitive update entries, where the
    gradient's own scale is below 1e-6, at their update bound; llama4's
    top-1 router, whose gradient is rounding noise, as a listed noise
    leaf); olmo-1b at full width, a bf16 step against an f32 step of the
    same weights: loss and grad norm within TRAIN_BF16_REL.  No kernel's
    launch count moves in phase 17.
18. LM training on a DeviceMesh (run after phase 17), which reaches no
    kernel of this port either.  (1) Full-width olmo-1b, bf16, AdamW,
    under its zero3 rules on a (1, 1) ``("data", "model")`` mesh of a
    one-rank NCCL group (the machine has one card), from phase 17's
    weights and batch: loss, grad norm and every state leaf within
    CPU_RTOL/CPU_ATOL of the unsharded step (bitwise or not is printed),
    every output leaf with its input's placements; then ms per step by
    CUDA events (median of TRAIN_TIMED after TRAIN_WARMUP) beside phase
    17's, tokens/s and MFU as phase 17 counts them: DTensor's host cost on
    this card.  (2) The elastic restore: reduced olmo-1b stepped once on
    that mesh, saved, restored onto the mesh and with ``device=`` alone,
    both bitwise.  (3) Two dry-run cells under this machine's torch on
    the single-pod mesh (a fake group of 256 ranks, fake CUDA tensors):
    olmo-1b train_4k and recurrentgemma-9b prefill_32k (38 layers of
    32768 positions, forward only); each one's seconds, per-device bytes
    and roofline terms, printed as a projection from datasheet rates.
    (4) Last, with 16.5 and 17.3, where one mesh step goes: wall ms
    beside the profiler's device-busy ms and the idle share.  No kernel's
    launch count moves in phase 18.
19. The log-depth RG-LRU scan (run after phase 18), recurrentgemma-9b at
    its published widths, weights drawn from ``--seed``.  (1)
    ``rg_lru`` on the first recurrent sublayer's weights at (1, S, 4096)
    for S in RG_SCAN_SEQS against ``rg_lru_ref`` (the sequential loop),
    in turns: outputs, and at the first S the gradients of x, w_a, w_x
    and lam, within SCAN_RTOL/SCAN_ATOL; forward ms both ways, and
    forward + backward ms at the first S (CUDA events, median of
    RG_REPS); their device kernels per call from a torch.profiler pass
    after phase 10, last.  (2) The full 38-layer model's ``prefill``
    of 1 x RG_PREFILL tokens in bf16: ms per prefill (CUDA events, median
    of RG_REPS), tokens/s, finite logits, RG_DECODE greedy decode steps;
    how far its last-position logits move with ``rg_lru_ref`` patched in,
    printed beside how far they move when the scan's output is one f32
    rounding step off (bf16 rounding through 38 random layers: ~3e-2 of
    the largest |logit| either way); then the same prefill in f32
    weights, scan against sequential within RG_F32_FRAC of the largest
    |logit|.  No kernel's launch count moves in phase 19.
20. The examples (run after phase 19): each ``examples/*_torch.py``
    through its ``main``, in-process, every launch count zeroed just
    before it and read just after.  (1) quickstart at its own size and
    (2) decompose_frostt on uber at each EXAMPLE_FROSTT_SCALES: B2 once
    per mode update and B1 once per inner iteration, no other kernel, no
    demotion, finite nonnegative factors, a finite nondecreasing
    log-likelihood; decompose_frostt's heuristic, given no platform, must
    print the ``cuda`` policy.  (3) serve_lm and (4) train_lm
    ``--steps`` 4 then 8 on one fresh checkpoint directory under
    ``build/chip_smoke/``, the second resuming at step 4, losses finite,
    each first at its defaults (the reduced preset, as the reference
    example runs: a smoke run whose rate is no metric) and then with
    ``--full`` (h2o-danube-1.8b and olmo-1b at their published widths in
    bf16; olmo-1b's checkpoints ~11 GiB each, removed): no kernel's count
    moves.  Each example's seconds, and its ms per sweep, tokens/s or ms
    per step, with the card's name and power limit.
10. One launch per fused dense step: the device kernels of one
    ``phi_mu_dense`` call on the near-dense tensor's mode 0, counted with
    torch.profiler (after every timed phase, so that none runs under its
    set-up; only 19.1's launch counts come later): one accumulation
    kernel and at most one fill of a few bytes.

The counted main-path solves of phases 3, 5 and 6 fail on any demotion
(``recoveries`` must be empty): a ladder that quietly ran a plain
strategy would otherwise pass as the kernel; so do phases 13's, 14's,
15's and 20's.  Phases 7-9 and 11-20 print their own times, and the
whole run its total.  The line before
the last is the per-kernel JSON record (``launches`` from the counted
runs of phases 3-7, ``service_launches`` from phase 13's,
``sharded_launches`` from phase 14's, ``grid_launches`` from phase
15's, ``example_launches`` from phase 20's); the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
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
# 1 - sqrt(|X|^2 - 2<X, M> + |M|^2) / |X| in f32: near 1.7e-4 on uber
# (the residual ratio near 0.99983), so its resolution is one f32 ulp of
# 1.0 (6e-8), that of the ratio it is taken from.  The kernel's per-call
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
# Phase 16, LM serving: the reference launcher's defaults
LM_BATCH, LM_PROMPT, LM_NEW = 4, 64, 32
# the two MoE giants at full width but cut depth (one card holds neither)
LM_DEPTH_CUT = {"qwen3-moe-235b-a22b": 2, "llama4-maverick-400b-a17b": 2}
# 16.2: the reference's teacher-forcing test and its tolerance
TF_ARCHS = ("olmo-1b", "mamba2-1.3b", "recurrentgemma-9b", "h2o-danube-1.8b")
TF_RTOL = TF_ATOL = 2e-2
# 16.3: reduced f32 configs, the card's ops against the CPU's; bf16
# against f32 of the same weights, as a share of the largest |logit|
CPU_RTOL, CPU_ATOL = 1e-4, 1e-5
BF16_FRAC = 3e-2
# Phase 17, LM training: the reference launcher's defaults (batch 8 x seq
# 128 = 1024 tokens per step, lr 3e-4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-4
TRAIN_WARMUP, TRAIN_TIMED = 2, 5  # olmo-1b: untimed, then timed steps
TRAIN_FULL_ONE = ("mamba2-1.3b", "whisper-medium")  # one full-width step
# 17.5: card vs CPU on reduced f32 steps (as 16.3, lr 1e-3 as the CPU
# tests); bf16 against f32 of the same weights: loss and grad norm
TRAIN_CMP_LR = 1e-3
TRAIN_BF16_REL = 3e-2
# dense bf16 tensor-core peak of an H100 SXM, published (NVIDIA H100
# datasheet, without sparsity): the bound of a bf16 train step's matmuls
BF16_TENSOR_FLOPS = 989.4e12
CARD_BYTES = 80 * 2 ** 30  # an H100 SXM's HBM3
# Phase 19, the RG-LRU scan: recurrentgemma-9b's train_4k and prefill_32k
# lengths at its published width; 5 timed calls a way (median)
RG_SCAN_SEQS = (4096, 32768)
RG_REPS = 5
RG_GRAD_KEYS = ("w_a", "w_x", "lam")  # 19.1's weight gradients, with x's
# the scan against the sequential loop in f32: the card's tier for
# reordered f32 sums (16.3's)
SCAN_RTOL, SCAN_ATOL = CPU_RTOL, CPU_ATOL
RG_PREFILL, RG_DECODE = 4096, 8  # 19.2: prompt (batch 1), greedy steps
# 19.2 in f32 weights: the scan against the sequential loop through 38
# layers, as a share of the largest |logit| (reordered f32 sums; moving
# the scan's output one f32 rounding step moves the logits as far)
RG_F32_FRAC = 1e-4
# 18.3's dry-run cells on the single-pod mesh under the card's torch:
# olmo-1b's train cell and the prefill cell the log-depth scan unblocks
MESH_DRYRUN_CELLS = (("olmo-1b", "train_4k"),
                     ("recurrentgemma-9b", "prefill_32k"))
# Phase 20, the examples: decompose_frostt at its default scale and at the
# published size; train_lm's two runs on one checkpoint directory (the
# second resumes from the first's last step)
EXAMPLE_FROSTT_SCALES = (0.003, 1.0)
EXAMPLE_TRAIN_STEPS = (4, 8)
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
        phi_p = ref.phi_blocked_arrays_ref(*plain_args, **kw)
        mu_p, viol_p = ref.phi_mu_blocked_arrays_ref(*plain_args, **kw)

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
                cuda_ms(ref.phi_blocked_arrays_ref, *plain_args, **kw,
                        iters=timing_iters),
                cuda_ms(phi_from_rows, *seg, strategy="segment", device=dev,
                        iters=timing_iters)),
            "phi_mu_blocked": (
                cuda_ms(ops.phi_mu_blocked, lay, vals_e, pi_e, b,
                        iters=timing_iters),
                cuda_ms(ref.phi_mu_blocked_arrays_ref, *plain_args, **kw,
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
        want = ref.mttkrp_blocked_arrays_ref(*plain_args, **kw)
        # per nonzero its value, local row and Khatri-Rao row (~72 bytes
        # at R = 16, f32); the f32 window written once
        isz = kr_e.element_size()
        nbytes = (mv.nnz * (isz + 4 + r * isz) + 4 * lay.n_grid
                  + 4 * lay.n_rows_pad * r)
        seg = (mv.rows, mv.sorted_vals, kr, mv.n_rows)
        times = (
            cuda_ms(ops.mttkrp_blocked, lay, vals_e, kr_e,
                    iters=timing_iters),
            cuda_ms(ref.mttkrp_blocked_arrays_ref, *plain_args, **kw,
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


def _handed_operands(kernel_mod) -> "contextlib.AbstractContextManager":
    """Within the block, the per-rank bytes
    (``perf.comm.entry_parameter_bytes``) of the operands each dense
    wrapper hands its kernel's launcher, by kernel name (``x``, ``c``,
    ``a`` and, for Φ and the fused step, ``b``).  The launches themselves
    run and count as ever."""
    import contextlib

    from repro_torch.perf.comm import entry_parameter_bytes

    launchers = {"dense_mttkrp": ("launch_mttkrp", 3),
                 "dense_phi": ("launch_phi", 4),
                 "dense_phi_mu": ("launch_phi_mu", 4)}

    @contextlib.contextmanager
    def spy():
        seen: dict = {}
        saved = {fn: getattr(kernel_mod, fn) for fn, _ in launchers.values()}
        for name, (fn, n_in) in launchers.items():
            def handed(*args, _name=name, _fn=saved[fn], _n=n_in, **kw):
                seen[_name] = sum(entry_parameter_bytes(args[:_n]))
                return _fn(*args, **kw)

            setattr(kernel_mod, fn, handed)
        try:
            yield seen
        finally:
            for fn, f in saved.items():
                setattr(kernel_mod, fn, f)

    return spy()


def dense_kernel_phase(t, init, timing_iters: int) -> dict:
    """Phase 6a: the three dense kernels on every mode of ``t``."""
    import torch

    from repro_torch.core.dense import build_dense_mode
    from repro_torch.core.phi import _dense_operands
    from repro_torch.core.sparse_tensor import sort_mode
    from repro_torch.kernels.dense import kernel, ops, ref
    from repro_torch.perf.comm import dense_input_bytes
    from repro_torch.perf.roofline import HARDWARE
    from repro_torch.perf.timing import cuda_ms

    check(HARDWARE["h100_sxm"].hbm_bw == HBM_BYTES_PER_S,
          "the kernels' byte bound and perf.roofline's H100 rate differ")
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
        with _handed_operands(kernel) as handed:
            phi_k = ops.phi_dense(x, c, a, b)
            mu_k, viol_k = ops.phi_mu_dense(x, c, a, b)
            m_k = ops.mttkrp_dense(x, c, a)
        torch.cuda.synchronize()
        phi_p = ref.phi_dense_ref(x, c, a, b, 1e-10)
        mu_p, viol_p = ref.phi_mu_dense_ref(x, c, a, b, 1e-10)
        m_p = ref.mttkrp_dense_ref(x, c, a)
        # bytes: the operands the wrappers hand the kernels (x, c, a and B:
        # perf.comm.dense_input_bytes, unpadded, as the port pads nothing)
        # read once, the (I, R) result written once; operations: per cell
        # 2R for the model value, one divide and 2R for the
        # back-contraction (MTTKRP: 2R), c∘a_k per slice, the a scaling per
        # (k, i, r), and 4 per entry for the MU epilogue
        isz = x.element_size()
        operands = {name: dense_input_bytes(k, i, j, r, isz,
                                            with_b=name != "dense_mttkrp")
                    for name in rows}
        print(f"dense mode {n} (K {k}, I {i}, J {j}): operand bytes handed "
              f"to the kernels " + ", ".join(
                  f"{name} {handed[name]:.0f}" for name in rows)
              + " (dense_input_bytes: " + ", ".join(
                  f"{operands[name]:.0f}" for name in rows) + ")")
        check(handed == operands,
              f"dense mode {n}: the wrappers hand their kernels {handed} "
              f"bytes, dense_input_bytes says {operands}")
        cells = k * i * j
        out = 4 * i * r
        phi_ops_n = cells * (4 * r + 1) + k * j * r + 2 * k * i * r
        sizes = {
            "dense_phi": (int(operands["dense_phi"]) + out, phi_ops_n),
            "dense_phi_mu": (int(operands["dense_phi_mu"]) + isz * i * r
                             + 4, phi_ops_n + 4 * i * r),
            "dense_mttkrp": (int(operands["dense_mttkrp"]) + out,
                             cells * 2 * r + 2 * k * i * r),
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
    print("B4-B6 bound from their dense_input_bytes operands plus the "
          "result at HARDWARE['h100_sxm'].hbm_bw "
          f"({HBM_BYTES_PER_S / 1e12:.2f} TB/s), summed over the modes: "
          + ", ".join(f"{name} {rows[name]['bound_ms']:.4f} ms"
                      for name in rows))
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
t, _ = random_poisson_tensor(0, (40, 30, 25), nnz=1500, rank=4,
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
        tj, _ = random_poisson_tensor(1000 * seed + j, shape, nnz=nnz,
                                      rank=SERVICE_RANK, device=dev)
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
        tensor_seed(name, seed) + 1, t.shape, nnz=int(APPEND_FRAC * t.nnz),
        rank=RANK, seed_ktensor=truth, device=dev)
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
    base, _ = random_poisson_tensor(seed + 7, shape,
                                    nnz=int(DENSE_CUT_BASE * cells),
                                    rank=RANK, device=dev)
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


def sharded_kernel_phase(t, init, mvs, layouts, timing_iters: int) -> dict:
    """14.1: B2 and B3 once per shard on per-shard windows (both combines,
    replicated and shard-local Π) against the same calls on the plain
    blocked schedule; exact launch counts; exact-zero padding rows; one
    sharded fused MU step per shard count as a CUDA-graph burst beside the
    unsharded ``cuda`` step.  Returns each sharded mode's step times."""
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
    mode_steps = {}
    for n in _shard_modes(layouts):
        mv, lay = mvs[n], layouts[n]
        pi = pi_rows(mv.sorted_idx, init.factors, n)
        b = init.factors[n] * init.lam[None, :]
        vals_e, pi_e = expand_to_layout(lay, mv.sorted_vals, pi)
        steps = mode_steps[n] = {"unsharded cuda": graph_ms(
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
    return mode_steps


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


def nccl_phase(t, init, mvs, layouts, dev) -> dict:
    """14.4: the collective code path on a one-rank NCCL process group;
    returns 14.6's recorded steps (:func:`nccl_recorded_steps`)."""
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
        return nccl_recorded_steps(mesh, init, mvs, layouts)
    finally:
        dist.destroy_process_group()


def nccl_recorded_steps(mesh, init, mvs, layouts) -> dict:
    """14.4's part for 14.6: on the one-rank NCCL group, the first sharded
    mode at S = 1 with the local cuda kernels, under
    ``perf.comm.record_collectives``: one fused owner step and one psum Φ
    in f32, and the psum Φ again on bf16 inputs.  Uncounted (the counts
    were read in 14.2 and 14.3)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.layout import owner_partition, shard_blocked_layout
    from repro_torch.core.phi import expand_to_shards
    from repro_torch.core.pi import pi_rows
    from repro_torch.perf.comm import record_collectives

    n = _shard_modes(layouts)[0]
    mv = mvs[n]
    sl = shard_blocked_layout(layouts[n], 1)
    opart = owner_partition(sl)
    pi = pi_rows(mv.sorted_idx, init.factors, n)
    b = init.factors[n] * init.lam[None, :]
    vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
    out = {"mode": n, "layout": sl, "owner_partition": opart}
    with record_collectives() as out["owner"]:
        D.phi_mu_sharded_owner(sl, opart, vals_es, pi_es,
                               D.owner_stack(opart, b, mesh), mesh=mesh,
                               local_strategy="cuda")
    with record_collectives() as out["psum"]:
        D.phi_sharded(sl, vals_es, pi_es, b, mesh=mesh, local_strategy="cuda")
    h = torch.bfloat16
    with record_collectives() as out["psum_bf16"]:
        D.phi_sharded(sl, vals_es.to(h), pi_es.to(h), b.to(h), mesh=mesh,
                      local_strategy="cuda")
    torch.cuda.synchronize()
    return out


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
    sinit = random_ktensor(seed, shape, RANK, device=dev).normalize()
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


def _pad_rows(n_rows: int, block_rows: int) -> int:
    """The row count the bounds of ``perf.comm`` pad a mode to."""
    return -(-max(n_rows, block_rows) // block_rows) * block_rows


def sharded_wire_phase(t, init, mvs, layouts, mode_steps: dict,
                       recorded: dict) -> None:
    """14.6: the sharded modes against the communication model
    (``perf.comm``, the JAX package's ``perf/hlo.py``) at S = 2 and 4:
    per-device wire of both combines from the layouts, the bounds, the
    Π-gather bytes of every shard, a projection of the S = N_SHARDS wire
    over NVLink, and 14.4's recorded one-rank NCCL steps."""
    from repro_torch.core import distributed as D
    from repro_torch.core.layout import (
        build_shard_pi_gather,
        owner_partition,
        shard_blocked_layout,
    )
    from repro_torch.core.phi import expand_vals_to_shards
    from repro_torch.perf import comm
    from repro_torch.perf.roofline import HARDWARE

    dev = t.device
    link = HARDWARE["h100_sxm_bf16"].link_bw
    for n in _shard_modes(layouts):
        mv, lay = mvs[n], layouts[n]
        br = lay.block_rows
        for s_count in SHARD_COUNTS:
            sl = shard_blocked_layout(lay, s_count)
            opart = owner_partition(sl)
            psum = comm.allreduce_wire_bytes(
                D.sharded_combine_bytes(sl, RANK), s_count)
            rs = D.owner_scatter_wire_bytes(opart, RANK)
            psum_bound = comm.phi_combine_wire_bound(mv.n_rows, RANK, s_count,
                                                     block_rows=br)
            rs_bound = comm.phi_reduce_scatter_wire_bound(
                mv.n_rows, RANK, s_count, block_rows=br)
            lower = comm.mttkrp_comm_lower_bound(mv.n_rows, RANK, s_count)
            ratio = opart.own_rows / (_pad_rows(mv.n_rows, br) / s_count)
            pref = D.preferred_combine(sl, RANK)
            print(f"mode {n} S={s_count} per-device wire bytes: psum {psum:.0f}"
                  f" (phi_combine_wire_bound {psum_bound:.0f}), "
                  f"reduce_scatter {rs:.0f} (phi_reduce_scatter_wire_bound "
                  f"{rs_bound:.0f}; owner window {opart.own_rows} rows, "
                  f"{ratio:.3f}x the mean), mttkrp_comm_lower_bound "
                  f"{lower:.0f}; preferred_combine {pref}; owned slice "
                  f"{opart.scatter_bytes(RANK)} B against the combine window "
                  f"{D.sharded_combine_bytes(sl, RANK)} B")
            check(0 < psum <= psum_bound,
                  f"mode {n} S={s_count}: the psum wire {psum} is outside "
                  f"phi_combine_wire_bound {psum_bound}")
            check(pref == ("reduce_scatter" if rs <= psum else "psum"),
                  f"mode {n} S={s_count}: preferred_combine {pref} does not "
                  f"follow the wire (reduce_scatter {rs}, psum {psum})")
            check(ratio > 2 or rs <= rs_bound,
                  f"mode {n} S={s_count}: owner windows within 2x the mean, "
                  f"but the reduce-scatter wire {rs} exceeds {rs_bound}")
            pig = build_shard_pi_gather(sl, mv.sorted_idx, n)
            vals_es = expand_vals_to_shards(sl, mv.sorted_vals)
            touched, lidx = pig.on(dev)
            valid = sl.on(dev).valid
            slot = sl.n_grid_shard * sl.block_nnz
            bound = comm.pi_gather_wire_bound(
                slot, pig.touched_rows_pad, RANK, t.ndim,
                idx_itemsize=lidx[0].element_size())
            repl = comm.pi_replicated_gather_bytes(t.shape, n, RANK)
            for s in range(s_count):
                vals, fg, li, v = D._pi_operands(pig, valid, touched, lidx,
                                                 vals_es, init.factors, s)
                got = sum(comm.entry_parameter_bytes([vals, *fg, *li, v]))
                rows_b = sum(comm.entry_parameter_bytes(fg))
                shares = ", ".join(
                    f"mode {m} {int(pig.touched_count[s, j])}/{t.shape[m]}"
                    for j, m in enumerate(pig.modes))
                print(f"  shard {s}: shard-local Π inputs {got:.0f} B "
                      f"(pi_gather_wire_bound {bound:.0f} at int64 index "
                      f"maps), touched factor rows {rows_b:.0f} B against "
                      f"pi_replicated_gather_bytes {repl:.0f} B "
                      f"({rows_b / repl:.3f}); rows touched {shares}")
                check(got <= bound, f"mode {n} S={s_count} shard {s}: the "
                                    f"shard-local Π inputs exceed the bound")
            if s_count == N_SHARDS:
                steps = mode_steps[n]
                print(f"  projection, not a measurement: the S={s_count} "
                      f"wire over NVLink at {link / 1e9:.0f} GB/s each way "
                      f"(datasheet): reduce_scatter {1e6 * rs / link:.3f} us, "
                      f"psum {1e6 * psum / link:.3f} us per combine, beside "
                      f"14.1's measured one-card fused step (all shards "
                      f"emulated, graph_ms): reduce_scatter "
                      f"{steps[f'S={s_count} reduce_scatter']:.4f} ms, psum "
                      f"{steps[f'S={s_count} psum']:.4f} ms")
    sl, opart = recorded["layout"], recorded["owner_partition"]
    for what, log in (("owner", recorded["owner"]),
                      ("psum", recorded["psum"]),
                      ("psum_bf16", recorded["psum_bf16"])):
        cs = comm.collective_stats(log)
        combine = log[0]
        model = (opart.scatter_bytes(RANK, combine.itemsize)
                 if what == "owner"
                 else D.sharded_combine_bytes(sl, RANK, combine.itemsize))
        print(f"one-rank NCCL group, mode {recorded['mode']} at S=1, {what} "
              f"step recorded: " + ", ".join(
                  f"{c.kind} {c.type} on {c.tag} ({c.group_size} rank)"
                  for c in log)
              + f"; counts {cs.by_kind_count}, wire {cs.wire_bytes:.0f} B; "
              f"combine result {combine.bytes:.0f} B (model {model} B)")
        want = ({"reduce-scatter": 1, "all-reduce": 1} if what == "owner"
                else {"all-reduce": 1})
        check(cs.by_kind_count == want and cs.wire_bytes == 0
              and combine.bytes == model,
              f"the one-rank {what} step recorded {log}, expected "
              f"{want} with a {model} B combine and no wire")


def sharded_phase(t, init, mvs, layouts, res, ref, dev, seed: int,
                  timing_iters: int) -> tuple:
    """Phase 14; returns the launch counts of its counted solves and its
    counted CP-APR solve."""
    t0 = time.perf_counter()
    mode_steps = sharded_kernel_phase(t, init, mvs, layouts, timing_iters)
    print(f"14.1 kernels per shard: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sh, launches = sharded_solve_phase(t, init, layouts, res, ref, dev)
    print(f"14.2 sharded CP-APR: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["mttkrp_blocked"] = sharded_als_phase(t, init, layouts, dev)
    print(f"14.3 sharded CP-ALS: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recorded = nccl_phase(t, init, mvs, layouts, dev)
    print(f"14.4 one-rank NCCL mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_ladder_phase(t, init, layouts, sh, dev, seed)
    print(f"14.5 ladder, rebalance, resume: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_wire_phase(t, init, mvs, layouts, mode_steps, recorded)
    print(f"14.6 communication model: {time.perf_counter() - t0:.1f} s")
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


def grid_nccl_phase(t, init, mvs, layouts, dev) -> list:
    """15.4: a (1, 1) grid on a one-rank NCCL process group against the
    emulated 1 x 1 grid solve; returns the collectives one fused grid
    step of mode 0 records there (15.6 reads them)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core.cpapr import cpapr_mu
    from repro_torch.core.distributed import make_grid_mesh
    from repro_torch.core.layout import build_grid_layout
    from repro_torch.core.phi import expand_to_grid
    from repro_torch.core.pi import pi_rows
    from repro_torch.perf.comm import record_collectives

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
        g = build_grid_layout(layouts[0], (1, 1))
        vals_cs, pi_cs = expand_to_grid(
            g, mvs[0].sorted_vals, pi_rows(mvs[0].sorted_idx, init.factors, 0))
        b = init.factors[0] * init.lam[None, :]
        with record_collectives() as log:
            D.phi_mu_grid_owner(g, vals_cs, pi_cs, D.grid_stack(g, b, mesh),
                                mesh=mesh, local_strategy="cuda")
        torch.cuda.synchronize()
        return log
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


def grid_wire_phase(t, mvs, layouts, recorded: list) -> None:
    """15.6: the explicit and the chosen grid of every mode against the
    communication model: the column wire is ``grid_combine_wire_bound``,
    at or above the Ballard/Knight/Rouse bound where the grid has a
    column axis, and below the S = N_SHARDS 1-D owner wire on grids of
    two or more rows (1 x B grids are printed); the (1, 1) NCCL grid of
    15.4 recorded no column collective."""
    from repro_torch.core import distributed as D
    from repro_torch.core.layout import build_grid_layout
    from repro_torch.perf import comm

    for n, (mv, lay) in enumerate(zip(mvs, layouts)):
        wire_1d = _owner_wire(lay, N_SHARDS)
        one_d = ("n/a (fewer row blocks than shards)" if math.isnan(wire_1d)
                 else f"{wire_1d:.0f}")
        for label, (a, bc) in _grid_shapes(mv, lay):
            g = build_grid_layout(lay, (a, bc))
            wire = D.grid_scatter_wire_bytes(g, RANK)
            model = comm.grid_combine_wire_bound(g.sub_rows, RANK, bc)
            lower = comm.mttkrp_comm_lower_bound(mv.n_rows, RANK, a * bc)
            print(f"mode {n} grid {a}x{bc} ({label}): column wire {wire:.0f} B"
                  f" per device per inner iteration (grid_combine_wire_bound"
                  f" {model:.0f}), mttkrp_comm_lower_bound {lower:.0f}, 1-D "
                  f"owner wire at S={N_SHARDS} {one_d}"
                  + ("" if a >= 2 or math.isnan(wire_1d)
                     else f" ({wire / wire_1d:.3f}x: a 1 x {bc} grid, "
                          f"printed only)"))
            check(wire == model and (bc == 1 or wire >= lower),
                  f"mode {n} grid {a}x{bc}: wire {wire}, model {model}, "
                  f"lower bound {lower}")
            check(a < 2 or wire < wire_1d,
                  f"mode {n} grid {a}x{bc}: the column wire {wire} is not "
                  f"below the 1-D owner wire {wire_1d}")
    print(f"one-rank NCCL (1, 1) grid, mode 0 fused step recorded: "
          + ", ".join(f"{c.kind} {c.type} on {c.tag}" for c in recorded))
    check([(c.kind, c.tag) for c in recorded] == [("all-reduce", "world")],
          f"the (1, 1) grid issued a column collective: {recorded}")


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
    recorded = grid_nccl_phase(t, init, mvs, layouts, dev)
    print(f"15.4 one-rank NCCL grid mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_ladder_phase(t, init, solves[(1, 4)], dev)
    print(f"15.5 grid ladder, resume: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grid_wire_phase(t, mvs, layouts, recorded)
    print(f"15.6 communication model: {time.perf_counter() - t0:.1f} s")
    return launches


class CountingLM:
    """A model's serving surface for ``Engine``: counts ``decode_step``
    calls and keeps one device flag for "every logit so far is finite"
    (read once, after the run)."""

    def __init__(self, model):
        self.model = model
        self.decode_calls = 0
        self.finite = None

    def _seen(self, logits):
        import torch

        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok

    def prefill(self, params, batch, cache_len=None):
        logits, caches = self.model.prefill(params, batch,
                                            cache_len=cache_len)
        self._seen(logits)
        return logits, caches

    def decode_step(self, params, caches, tokens):
        self.decode_calls += 1
        logits, caches = self.model.decode_step(params, caches, tokens)
        self._seen(logits)
        return logits, caches


def event_ms(fn, reps: int) -> list:
    """Device ms of ``reps`` calls of ``fn`` (CUDA events around each)."""
    import torch
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def tree_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def decode_weight_bytes(cfg, params) -> int:
    """Weight bytes one decode step reads: all but an untied input
    embedding table (4 rows of it are gathered), Whisper's encoder, and
    the dense FFN of a MoE sublayer (its weights exist but go unused)."""
    skip = {"encdec": ("enc_blocks", "enc_final", "enc_final_b")}.get(
        cfg.family, () if cfg.tie_embeddings else ("embed",))
    n = sum(tree_bytes(v) for k, v in params.items() if k not in skip)
    if cfg.n_experts and cfg.moe_every > 1:
        n -= sum(tree_bytes(params["blocks"][k]) // cfg.moe_every
                 for k in ("wi_gate", "wi_up", "wi", "wo_mlp")
                 if k in params["blocks"])
    return n


def lm_serve_one(cfg, dev, seed: int) -> dict:
    """16.1 for one config: serve LM_BATCH prompts, check and time."""
    import gc
    import statistics

    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, ServeConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    shape = ShapeConfig("serve", LM_PROMPT + cfg.n_patches, LM_BATCH,
                        "prefill")
    batch = model.make_batch(seed + 1, shape, device=dev)
    counting = CountingLM(model)
    eng = Engine(counting, params, ServeConfig(max_new_tokens=LM_NEW),
                 device=dev)
    t0 = time.perf_counter()
    out = eng.generate(batch, seed=seed + 2)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    check(counting.decode_calls == LM_NEW - 1,
          f"{cfg.name}: {counting.decode_calls} decode_step calls, "
          f"expected {LM_NEW - 1}")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW),
          f"{cfg.name}: tokens of shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_pad)).all()),
          f"{cfg.name}: token ids outside [0, {cfg.vocab_pad})")
    check(bool(counting.finite), f"{cfg.name}: a non-finite logit")
    t0 = time.perf_counter()
    again = eng.generate(batch, seed=seed + 2)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    check(torch.equal(again, out), f"{cfg.name}: greedy tokens changed "
          f"between two runs")
    cache_len = LM_PROMPT + cfg.n_patches + LM_NEW
    prefill_ms = statistics.median(event_ms(
        lambda: model.prefill(params, batch, cache_len=cache_len), 3))
    logits, caches = model.prefill(params, batch, cache_len=cache_len)
    tok = torch.argmax(logits, dim=-1)[:, None]

    def step():
        nonlocal tok
        lg, _ = model.decode_step(params, caches, tok)
        tok = torch.argmax(lg, dim=-1)[:, None]

    decode_ms = statistics.median(event_ms(step, LM_NEW - 1))
    w_bytes, c_bytes = tree_bytes(params), tree_bytes(caches)
    read = decode_weight_bytes(cfg, params) + c_bytes
    bound_ms = 1e3 * read / HBM_BYTES_PER_S
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "weight_bytes": w_bytes, "cache_bytes": c_bytes,
           "decode_read_bytes": read, "init_s": init_s,
           "first_generate_s": first_s, "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "decode_bound_ms": bound_ms,
           "decode_over_bound": decode_ms / bound_ms,
           "tokens_per_s": LM_BATCH * LM_NEW / warm_s,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del params, caches, logits, eng, counting, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_teacher_forcing(name: str, dev, seed: int) -> float:
    """16.2: prefill 8 + decode 4 against forward logits, full width, f32.
    Returns the largest error over the allowance's scale."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import matmul_f32

    cfg = dataclasses.replace(get_arch(name), dtype="float32")
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen, device=dev,
                           dtype=torch.int32)
    with torch.inference_mode():
        hidden = model.forward(params, {"tokens": torch.nn.functional.pad(
            tokens, (0, 1))})
        tf = matmul_f32(hidden, params["embed"].T)
    worst = 0.0
    logits, caches = model.prefill(params, {"tokens": tokens[:, :8]},
                                   cache_len=12)
    pairs = [(logits, tf[:, 7])]
    for i in range(8, 12):
        logits, caches = model.decode_step(params, caches,
                                           tokens[:, i:i + 1])
        pairs.append((logits, tf[:, i]))
    for got, want in pairs:
        d = (got - want).abs()
        worst = max(worst, float((d / (TF_ATOL + TF_RTOL * want.abs()))
                                 .max()))
    print(f"16.2 {name} f32 full width: decode vs teacher forcing, worst "
          f"|err| / (atol + rtol |ref|) = {worst:.3e} (rtol {TF_RTOL}, "
          f"atol {TF_ATOL}), max |logit| {float(tf.abs().max()):.3e}")
    check(worst <= 1.0, f"{name}: decode disagrees with teacher forcing")
    del params, caches, hidden, tf
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def lm_card_vs_cpu(name: str, dev, seed: int) -> float:
    """16.3: a reduced f32 config, the same weights on the CPU and the
    card, prefill + 3 decode steps fed the CPU's greedy tokens."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch(name))
    model = build_model(cfg)
    cpu = torch.device("cpu")
    p_cpu = model.init(seed, device=cpu)
    b_cpu = model.make_batch(seed + 1, ShapeConfig("p", 24, 2, "prefill"),
                             device=cpu)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    cache_len = 24 + cfg.n_patches + 3
    lc, cc = model.prefill(p_cpu, b_cpu, cache_len=cache_len)
    ld, cd = model.prefill(p_dev, b_dev, cache_len=cache_len)
    worst = 0.0
    for i in range(4):
        d = (ld.cpu() - lc).abs()
        worst = max(worst, float((d / (CPU_ATOL + CPU_RTOL * lc.abs()))
                                 .max()))
        if i == 3:
            break
        tok = torch.argmax(lc, dim=-1)[:, None]
        lc, cc = model.decode_step(p_cpu, cc, tok)
        ld, cd = model.decode_step(p_dev, cd, tok.to(dev))
    print(f"16.3 {cfg.name}: card vs CPU, prefill + 3 decode steps, worst "
          f"|err| / (atol + rtol |cpu|) = {worst:.3e} (rtol {CPU_RTOL}, "
          f"atol {CPU_ATOL})")
    check(worst <= 1.0, f"{cfg.name}: the card disagrees with the CPU")
    return worst


def lm_bf16_vs_f32(dev, seed: int) -> float:
    """16.3: olmo-1b's first-token logits, bf16 against f32 of the same
    weights, as a share of the largest f32 |logit|."""
    import gc

    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_map

    cfg = get_arch("olmo-1b")
    m16 = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p16 = m16.init(seed, device=dev)
    with torch.inference_mode():
        p32 = tree_map(lambda t: t.float(), p16)
    batch = m16.make_batch(seed + 1, ShapeConfig(
        "serve", LM_PROMPT, LM_BATCH, "prefill"), device=dev)
    l16, _ = m16.prefill(p16, batch)
    l32, _ = m32.prefill(p32, batch)
    frac = float((l16 - l32).abs().max() / l32.abs().max())
    print(f"16.3 olmo-1b first-token logits, bf16 vs f32 of the same "
          f"weights: max |diff| / max |f32 logit| = {frac:.3e} (limit "
          f"{BF16_FRAC}), max |logit| {float(l32.abs().max()):.3e}")
    check(frac <= BF16_FRAC, "olmo-1b bf16 logits stray from f32")
    del p16, p32
    gc.collect()
    torch.cuda.empty_cache()
    return frac


def lm_decode_trace(dev, seed: int, steps: int = 8) -> dict:
    """16.5: where one olmo-1b decode step's time goes (bf16, batch
    LM_BATCH, after a LM_PROMPT prefill): wall ms per step (CUDA events,
    median), device-busy ms per step (the union of the device intervals
    torch.profiler records over ``steps`` steps), device kernels per step
    and the five largest by device time."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.perf.trace import busy_us

    cfg = get_arch("olmo-1b")
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    batch = model.make_batch(seed + 1, ShapeConfig(
        "serve", LM_PROMPT, LM_BATCH, "prefill"), device=dev)
    logits, caches = model.prefill(params, batch,
                                   cache_len=LM_PROMPT + 4 * steps)
    tok = torch.argmax(logits, dim=-1)[:, None]

    def step():
        nonlocal tok
        lg, _ = model.decode_step(params, caches, tok)
        tok = torch.argmax(lg, dim=-1)[:, None]

    wall_ms = statistics.median(event_ms(step, steps))
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in on_dev]) / 1e3 / steps
    by_name: dict = {}
    for e in on_dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_kernels_per_step": len(on_dev) / steps,
           "top_kernels_ms": [(n[:80], ms) for n, ms in top]}
    print(f"16.5 olmo-1b decode step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {rec['device_idle_share']:.3f}), "
          f"{rec['device_kernels_per_step']:.1f} device kernels per step; "
          f"top by device ms: " + "; ".join(
              f"{n} {ms:.3f}" for n, ms in rec["top_kernels_ms"]))
    check(len(on_dev) > 0, "the profiler saw no device work in decode")
    del params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count (the ten of the record)."""
    from repro_torch.kernels.dense import ops as dense_ops
    from repro_torch.kernels.mttkrp import ops as mttkrp_ops
    from repro_torch.kernels.phi import ops as phi_ops
    from repro_torch.kernels.stream import ops as stream_ops

    return {**phi_ops.launch_counts, **mttkrp_ops.launch_counts,
            **dense_ops.launch_counts, **stream_ops.launch_counts}


def reset_kernel_launch_counts() -> None:
    from repro_torch.kernels.dense import ops as dense_ops
    from repro_torch.kernels.mttkrp import ops as mttkrp_ops
    from repro_torch.kernels.phi import ops as phi_ops
    from repro_torch.kernels.stream import ops as stream_ops

    for ops in (phi_ops, mttkrp_ops, dense_ops, stream_ops):
        ops.reset_launch_counts()


def lm_phase(dev, seed: int) -> list:
    """Phase 16: LM serving on the card (16.1-16.4).  The LM path reaches
    none of the port's kernels: their launch counts must not move."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as serve_launch

    before = kernel_launch_counts()
    t0 = time.perf_counter()
    recs = []
    for name, cfg in ARCHS.items():
        cut = LM_DEPTH_CUT.get(name)
        if cut:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        rec = lm_serve_one(cfg, dev, seed)
        depth = (f"depth cut {ARCHS[name].n_layers} -> {cut} layers"
                 if cut else f"full depth {cfg.n_layers} layers")
        print(f"16.1 {name} ({depth}), bf16, batch {LM_BATCH}, prompt "
              f"{LM_PROMPT}{' + 1024 patches' if cfg.n_patches else ''}, "
              f"{LM_NEW} new: prefill {rec['prefill_ms']:.3f} ms, decode "
              f"{rec['decode_ms']:.3f} ms/step (bound "
              f"{rec['decode_bound_ms']:.4f} ms, x"
              f"{rec['decode_over_bound']:.1f}), "
              f"{rec['tokens_per_s']:.1f} tok/s; weights "
              f"{rec['weight_bytes'] / 2 ** 30:.2f} GiB, cache "
              f"{rec['cache_bytes'] / 2 ** 20:.1f} MiB, peak "
              f"{rec['peak_gib']:.2f} GiB")
        recs.append(rec)
    print("16.1 records: " + json.dumps(recs))
    print(f"16.1 serve every config: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in TF_ARCHS:
        lm_teacher_forcing(name, dev, seed)
    print(f"16.2 teacher forcing: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in ARCHS:
        lm_card_vs_cpu(name, dev, seed)
    lm_bf16_vs_f32(dev, seed)
    print(f"16.3 card vs CPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rc = serve_launch.main(["--arch", "olmo-1b", "--full"])
    check(rc == 0, f"the --arch launcher returned {rc}")
    torch.cuda.empty_cache()
    print(f"16.4 --arch olmo-1b --full: {time.perf_counter() - t0:.1f} s")
    check(kernel_launch_counts() == before,
          "the LM path launched one of the port's kernels")
    print(f"phase 16 launched none of the {len(before)} kernels")
    return recs


# ---------------------------------------------------------------------------
# Phase 17: LM training on one device
# ---------------------------------------------------------------------------


def train_state_bytes(cfg) -> dict:
    """Bytes of one train step's state at ``cfg``'s size, from its specs
    (no allocation): parameters, the optimizer state of ``cfg.optimizer``
    and the f32 gradients."""
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import opt_state_specs

    def nbytes(tree):
        return sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in tree_leaves(tree))

    specs = build_model(cfg).param_specs()
    n = sum(math.prod(s.shape) for s in tree_leaves(specs))
    out = {"params": nbytes(specs),
           "opt": nbytes(opt_state_specs(cfg.optimizer, specs)),
           "grads_f32": 4 * n}
    out["total"] = sum(out.values())
    return out


def _train_setup(cfg, dev, seed: int, lr: float = TRAIN_LR, batch=None):
    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import init_state, make_train_step

    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=lr)
    state = init_state(model, opt, seed, device=dev)
    shape = ShapeConfig("train", TRAIN_SEQ, batch or TRAIN_BATCH, "train")
    pipe = TokenPipeline(cfg, shape, seed=seed, device=dev)
    return model, make_train_step(model, opt), state, pipe


def lm_train_launcher(dev, seed: int) -> None:
    """17.1: ``launch.train.main`` at full width (olmo-1b, bf16), 6 steps
    with a checkpoint every 3, then the same command with ``--steps 8``,
    which must resume at step 6 and end at step 8."""
    import contextlib
    import io
    import shutil

    import torch
    from repro_torch.launch import train as train_launch
    from repro_torch.train.checkpoint import latest_step

    ck = os.path.join(HERE, "build", "chip_smoke", "train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "olmo-1b", "--full", "--ckpt-every", "3",
            "--ckpt-dir", ck, "--seed", str(seed)]
    try:
        for steps, start in ((6, 0), (8, 6)):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = train_launch.main(argv + ["--steps", str(steps)])
            secs = time.perf_counter() - t0
            lines = out.getvalue().splitlines()
            for ln in lines:
                print(f"17.1   {ln}")
            check(rc == 0, f"launch.train returned {rc}")
            check(f"start_step={start}" in lines[0],
                  f"--steps {steps}: expected start_step={start}: {lines[0]}")
            check(lines[-1].startswith(f"[train] done at step {steps}"),
                  f"--steps {steps}: {lines[-1]}")
            check(latest_step(ck) == steps, f"LATEST is {latest_step(ck)}")
            n = sum(ln.startswith("[train] step") for ln in lines)
            check(n == steps - start, f"{n} step lines, expected "
                  f"{steps - start}")
            ckpt_mb = sum(os.path.getsize(os.path.join(ck, f))
                          for f in os.listdir(ck)) / 2 ** 20
            print(f"17.1 launch.train --arch olmo-1b --full --steps {steps} "
                  f"--ckpt-every 3: start {start}, {secs:.1f} s (init or "
                  f"restore, steps, checkpoints), {ckpt_mb:.0f} MiB on disk")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def lm_train_timed(dev, seed: int) -> dict:
    """17.2: full-width olmo-1b, bf16, AdamW, batch TRAIN_BATCH x seq
    TRAIN_SEQ, remat as the config says (per layer), TF32 off.  Per step:
    median ms by CUDA events and by the host clock (the step ends on a
    host read of its loss), tokens/s, peak memory, state bytes and MFU."""
    import gc
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import count_params
    from repro_torch.train.step import _value_and_grad

    cfg = get_arch("olmo-1b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, step, state, pipe = _train_setup(cfg, dev, seed)
    batch = pipe.make_batch(0)
    losses, dev_ms, host_ms = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, batch)
        b.record()
        loss = float(m["loss"])
        host = 1e3 * (time.perf_counter() - t0)
        b.synchronize()
        losses.append(loss)
        if i >= TRAIN_WARMUP:
            dev_ms.append(a.elapsed_time(b))
            host_ms.append(host)
    check(all(math.isfinite(x) for x in losses),
          f"olmo-1b full-width losses not finite: {losses}")
    # the loss and its gradient alone (forward, remat's recompute and the
    # backward): the rest of the step is casts, clip and the update
    grad_ms = statistics.median(event_ms(
        lambda: _value_and_grad(model, state["params"], batch), 3))
    n_params = count_params(model.param_specs())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = statistics.median(dev_ms)
    rec = {"arch": cfg.name, "params": n_params, "tokens_per_step": tokens,
           "ms_per_step": ms, "host_ms_per_step": statistics.median(host_ms),
           "loss_and_grad_ms": grad_ms,
           "step_ms": dev_ms, "tokens_per_s": tokens / (ms / 1e3),
           "model_flops_per_step": 6.0 * n_params * tokens,
           "state_bytes": tree_bytes(state),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "losses": losses}
    rec["mfu"] = rec["model_flops_per_step"] / (ms / 1e3) / BF16_TENSOR_FLOPS
    print(f"17.2 olmo-1b full width, bf16, AdamW, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ} ({tokens} tokens), remat per layer: "
          f"{ms:.3f} ms/step by CUDA events (host clock "
          f"{rec['host_ms_per_step']:.3f} ms; the loss and its gradient "
          f"alone {grad_ms:.3f} ms), {rec['tokens_per_s']:.0f} "
          f"tokens/s, MFU {rec['mfu']:.4f} (6 N T = "
          f"{rec['model_flops_per_step']:.4e} FLOP over "
          f"{BF16_TENSOR_FLOPS:.4e} FLOP/s; remat's recomputed forward is "
          f"not counted: MFU counts the model's FLOPs, not the hardware's); "
          f"state {rec['state_bytes'] / 2 ** 30:.2f} GiB, peak "
          f"{rec['peak_gib']:.2f} GiB; step ms {[round(x, 3) for x in dev_ms]}"
          f"; losses {[round(x, 4) for x in losses]}")
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_train_bf16_vs_f32(dev, seed: int) -> None:
    """17.5: olmo-1b full width, one step in bf16 and one in f32 from the
    same weights (the bf16 ones upcast) and batch: loss and grad norm
    within TRAIN_BF16_REL of the f32 step's."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_map

    cfg16 = get_arch("olmo-1b")
    out = []
    for cfg in (cfg16, dataclasses.replace(cfg16, dtype="float32")):
        model, step, state, pipe = _train_setup(cfg, dev, seed)
        if cfg.dtype == "float32":  # the bf16 draw, upcast
            del state["params"]
            state["params"] = tree_map(lambda t: t.float(), build_model(
                cfg16).init(seed, device=dev))
        _, m = step(state, pipe.make_batch(0))
        out.append((float(m["loss"]), float(m["grad_norm"])))
        del model, step, state, m
        gc.collect()
        torch.cuda.empty_cache()
    (l16, g16), (l32, g32) = out
    rl, rg = abs(l16 - l32) / abs(l32), abs(g16 - g32) / abs(g32)
    print(f"17.5 olmo-1b full width, one step bf16 vs f32 of the same "
          f"weights: loss {l16:.6f} vs {l32:.6f} (rel {rl:.3e}), grad norm "
          f"{g16:.6f} vs {g32:.6f} (rel {rg:.3e}); limit {TRAIN_BF16_REL}")
    check(rl <= TRAIN_BF16_REL and rg <= TRAIN_BF16_REL,
          "olmo-1b bf16 train step strays from f32")


def lm_train_full_one(name: str, dev, seed: int) -> dict:
    """17.4: one full-width bf16 step of ``name`` (after one untimed
    step): ms (CUDA events), loss finite, peak memory."""
    import gc

    import torch
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, step, state, pipe = _train_setup(cfg, dev, seed)
    batch = pipe.make_batch(0)
    state, m0 = step(state, batch)
    first = float(m0["loss"])
    ms = event_ms(lambda: step(state, batch)[1]["loss"].item(), 1)[0]
    rec = {"arch": name, "ms_per_step": ms, "loss": first,
           "state_bytes": tree_bytes(state),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    print(f"17.4 {name} full width, bf16, {cfg.optimizer}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: {ms:.3f} ms/step, loss "
          f"{first:.4f}, state {rec['state_bytes'] / 2 ** 30:.2f} GiB, peak "
          f"{rec['peak_gib']:.2f} GiB")
    check(math.isfinite(first), f"{name}: loss not finite")
    del state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_train_reduced(name: str, dev, seed: int) -> dict:
    """17.5 for one reduced f32 config: (1) on the card, the same batch
    stepped twice: losses finite and falling; (2) one step on the card
    against the CPU from the same weights and batch: loss, grad norm and
    every state leaf within CPU_RTOL/CPU_ATOL (rounding-sensitive update
    entries at their bound, ``repro_torch.testing.train_parity``)."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.params import tree_map
    from repro_torch.testing.train_parity import compare_states

    cfg = reduced(get_arch(name))
    model, step, state, pipe = _train_setup(cfg, dev, seed,
                                            lr=TRAIN_CMP_LR, batch=2)
    batch = pipe.make_batch(0)
    s1, m1 = step(state, batch)
    _, m2 = step(s1, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    check(math.isfinite(l1) and math.isfinite(l2) and l2 < l1,
          f"{cfg.name}: the same batch stepped twice: {l1} -> {l2}")
    cpu = torch.device("cpu")
    s_cpu, m_cpu = step(tree_map(lambda t: t.to(cpu), state),
                        {k: v.to(cpu) for k, v in batch.items()})
    rel = max(abs(float(m1[k]) - float(m_cpu[k]))
              / (CPU_ATOL + CPU_RTOL * abs(float(m_cpu[k])))
              for k in ("loss", "grad_norm"))
    cmp = compare_states(s1, s_cpu, TRAIN_CMP_LR, CPU_RTOL, CPU_ATOL)
    print(f"17.5 {cfg.name}: losses {l1:.5f} -> {l2:.5f}; card vs CPU "
          f"one step: loss/grad norm {rel:.3e}, state worst {cmp['worst']:.3e}"
          f" of the allowance, sensitive entries {cmp['n_sensitive_out']} "
          f"out (worst {cmp['sensitive_worst']:.3e} of 2 lr), noise leaves "
          f"{cmp['noise_leaves']}")
    check(rel <= 1.0 and cmp["worst"] <= 1.0 and cmp["sensitive_worst"] <= 1.0
          and cmp["n_sensitive_out"] <= 8,
          f"{cfg.name}: the card's train step disagrees with the CPU's")
    check(cmp["noise_leaves"] == (["blocks/router"] if cfg.top_k == 1
                                  else []),
          f"{cfg.name}: unexpected noise leaves {cmp['noise_leaves']}")
    return {"arch": cfg.name, "losses": [l1, l2], "card_vs_cpu": cmp,
            "metric_ratio": rel}


def lm_train_trace(dev, seed: int, steps: int = 2) -> dict:
    """17.3: where one full-width olmo-1b train step goes: wall ms per
    step (CUDA events) beside the device-busy ms torch.profiler records
    over ``steps`` steps, the idle share, device kernels per step and the
    five largest by device ms.  Run last, as 16.5."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.perf.trace import busy_us

    model, step, state, pipe = _train_setup(get_arch("olmo-1b"), dev, seed)
    batch = pipe.make_batch(0)
    box = [state]

    def one():
        box[0], m = step(box[0], batch)
        float(m["loss"])

    one()
    wall_ms = statistics.median(event_ms(one, steps))
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize(dev)
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in on_dev]) / 1e3 / steps
    by_name: dict = {}
    for e in on_dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_kernels_per_step": len(on_dev) / steps,
           "top_kernels_ms": [(n[:80], ms) for n, ms in top]}
    print(f"17.3 olmo-1b train step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {rec['device_idle_share']:.3f}), "
          f"{rec['device_kernels_per_step']:.1f} device kernels per step; "
          f"top by device ms: " + "; ".join(
              f"{n} {ms:.3f}" for n, ms in rec["top_kernels_ms"]))
    check(len(on_dev) > 0, "the profiler saw no device work in a train step")
    del box, state, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_phase(dev, seed: int) -> dict:
    """Phase 17: LM training on the card (17.1, 17.2, 17.4, 17.5; 17.3
    runs last).  The training path reaches none of the port's kernels:
    their launch counts must not move."""
    from repro_torch.configs import ARCHS, reduced

    before = kernel_launch_counts()
    out = {}
    t0 = time.perf_counter()
    lm_train_launcher(dev, seed)
    print(f"17.1 launcher and resume: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["olmo"] = lm_train_timed(dev, seed)
    print(f"17.2 timed olmo-1b steps: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full_one"] = [lm_train_full_one(n, dev, seed) for n in TRAIN_FULL_ONE]
    for name, cfg in ARCHS.items():
        if name in TRAIN_FULL_ONE or name == "olmo-1b":
            continue
        b = train_state_bytes(cfg)
        fits = b["total"] < CARD_BYTES
        print(f"17.4 {name} at full width: params "
              f"{b['params'] / 2 ** 30:.1f} GiB + {cfg.optimizer} state "
              f"{b['opt'] / 2 ** 30:.1f} GiB + f32 grads "
              f"{b['grads_f32'] / 2 ** 30:.1f} GiB = "
              f"{b['total'] / 2 ** 30:.1f} GiB before activations: "
              + ("fits the card, not stepped here (its family's backward "
                 "runs in 17.2)" if fits else
                 f"does not fit one {CARD_BYTES / 2 ** 30:.0f} GiB card; "
                 f"it trains reduced only (17.5)"))
    print(f"17.4 full-width steps: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["reduced"] = [lm_train_reduced(n, dev, seed) for n in ARCHS]
    lm_train_bf16_vs_f32(dev, seed)
    print(f"17.5 correctness: {time.perf_counter() - t0:.1f} s")
    check(kernel_launch_counts() == before,
          "the training path launched one of the port's kernels")
    print(f"phase 17 launched none of the {len(before)} kernels")
    print("17 records: " + json.dumps(
        {"olmo": out["olmo"], "full_one": out["full_one"]}))
    return out


# ---------------------------------------------------------------------------
# Phase 18: LM training on a DeviceMesh
# ---------------------------------------------------------------------------


def _mesh11(dev):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def _placed(tree, shardings):
    from repro_torch.models.params import tree_map

    return tree_map(lambda x, sh: sh.place(x), tree, shardings)


def _mesh_setup(cfg, dev, seed: int, lr: float = TRAIN_LR, batch=None):
    """Phase 17's ``_train_setup`` plus the (1, 1) mesh's layouts: (model,
    step, plain state, plain batch, state shardings, batch shardings)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.mesh import batch_shardings, state_shardings
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import state_specs

    mesh = _mesh11(dev)
    model, step, state, pipe = _train_setup(cfg, dev, seed, lr=lr,
                                            batch=batch)
    shape = ShapeConfig("train", TRAIN_SEQ, batch or TRAIN_BATCH, "train")
    sh = state_shardings(state_specs(model, make_optimizer(cfg.optimizer)),
                         mesh)
    bsh = batch_shardings(model.input_specs(shape), mesh)
    return model, step, state, pipe.make_batch(0), sh, bsh


def mesh_train_step(dev, seed: int, p17: dict) -> dict:
    """18.1: full-width olmo-1b, bf16, AdamW, under its zero3 rules, on a
    one-rank (1, 1) ``("data", "model")`` mesh: the DTensor step from
    phase 17's weights and batch against the unsharded step (loss, grad
    norm and every state leaf within CPU_RTOL/CPU_ATOL, the sensitive
    update entries at their bound; bitwise or not is printed), the output
    placements against the input's, then ms per step by CUDA events
    (median of TRAIN_TIMED after TRAIN_WARMUP) beside phase 17's, tokens/s
    and MFU as phase 17 counts them."""
    import gc
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import (count_params, set_rules_profile,
                                           tree_leaves, tree_map)
    from repro_torch.testing.train_parity import compare_states

    cfg = get_arch("olmo-1b")
    set_rules_profile(cfg.sharding_profile)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model, step, state, batch, sh, bsh = _mesh_setup(cfg, dev, seed)
        want, m_want = step(state, batch)
        dstate = _placed(state, sh)
        dbatch = {k: bsh[k].place(v) for k, v in batch.items()}
        del state
        got, m_got = step(dstate, dbatch)
        kept = all(tuple(a.placements) == tuple(b.placements)
                   for a, b in zip(tree_leaves(got), tree_leaves(dstate)))
        plain = tree_map(lambda t: t.to_local(), got)
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(plain), tree_leaves(want))) and all(
            torch.equal(m_got[k], m_want[k]) for k in ("loss", "grad_norm"))
        rel = max(abs(float(m_got[k]) - float(m_want[k]))
                  / (CPU_ATOL + CPU_RTOL * abs(float(m_want[k])))
                  for k in ("loss", "grad_norm"))
        cmp = compare_states(plain, want, TRAIN_LR, CPU_RTOL, CPU_ATOL)
        print(f"18.1 olmo-1b full width, bf16, AdamW, zero3 rules on a (1, 1)"
              f" mesh (one-rank NCCL group) vs the unsharded step of the same "
              f"weights and batch: bitwise {bitwise}; loss "
              f"{float(m_got['loss']):.6f} vs {float(m_want['loss']):.6f}, "
              f"grad norm {float(m_got['grad_norm']):.6f} vs "
              f"{float(m_want['grad_norm']):.6f} ({rel:.3e} of CPU_RTOL/"
              f"CPU_ATOL); state worst {cmp['worst']:.3e} of the allowance, "
              f"sensitive entries {cmp['n_sensitive_out']} out; placements "
              f"kept {kept}")
        check(kept, "the mesh step changed a leaf's placements")
        check(rel <= 1.0 and cmp["worst"] <= 1.0
              and cmp["sensitive_worst"] <= 1.0
              and cmp["n_sensitive_out"] <= 8 and not cmp["noise_leaves"],
              "the (1, 1) mesh step disagrees with the unsharded step")
        del want, got, plain, m_want
        box = [dstate]

        def one():
            box[0], m = step(box[0], dbatch)
            float(m["loss"])

        for _ in range(TRAIN_WARMUP):
            one()
        dev_ms = event_ms(one, TRAIN_TIMED)
        n_params = count_params(model.param_specs())
        tokens = TRAIN_BATCH * TRAIN_SEQ
        ms = statistics.median(dev_ms)
        rec = {"arch": cfg.name, "mesh": [1, 1], "rules": "zero3",
               "bitwise": bitwise, "ms_per_step": ms, "step_ms": dev_ms,
               "phase17_ms_per_step": p17["ms_per_step"],
               "tokens_per_s": tokens / (ms / 1e3),
               "mfu": 6.0 * n_params * tokens / (ms / 1e3)
               / BF16_TENSOR_FLOPS,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        print(f"18.1 timed: {ms:.3f} ms/step by CUDA events on the (1, 1) "
              f"mesh beside phase 17's unsharded {p17['ms_per_step']:.3f} "
              f"ms/step ({ms / p17['ms_per_step']:.3f}x: DTensor's host cost "
              f"on this card), {rec['tokens_per_s']:.0f} tokens/s, MFU "
              f"{rec['mfu']:.4f}, peak {rec['peak_gib']:.2f} GiB; step ms "
              f"{[round(x, 3) for x in dev_ms]}")
        del box, dstate, step, model, batch, dbatch
    finally:
        set_rules_profile("tp_fsdp")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_elastic_restore(dev, seed: int) -> None:
    """18.2: reduced olmo-1b (f32) stepped once on the (1, 1) mesh, saved
    (rank 0 writes full arrays), restored onto the mesh (``shardings=``)
    and onto the card with ``device=`` alone: both bitwise the state that
    was saved, the mesh copy with the target placements."""
    import shutil

    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.params import (abstract_params,
                                           set_rules_profile, tree_leaves)
    from repro_torch.train.checkpoint import restore, save
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import state_specs

    cfg = reduced(get_arch("olmo-1b"))
    ck = os.path.join(HERE, "build", "chip_smoke", "mesh_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    set_rules_profile(cfg.sharding_profile)
    try:
        model, step, state, batch, sh, bsh = _mesh_setup(
            cfg, dev, seed, lr=TRAIN_CMP_LR, batch=2)
        s1, _ = step(_placed(state, sh),
                     {k: bsh[k].place(v) for k, v in batch.items()})
        save(ck, 1, s1)
        target = abstract_params(state_specs(model,
                                             make_optimizer(cfg.optimizer)))
        on_mesh, step_m = restore(ck, target, shardings=sh)
        on_dev, step_d = restore(ck, target, device=dev)
        want = [t.full_tensor() for t in tree_leaves(s1)]
        ok_mesh = all(torch.equal(a.full_tensor(), b) for a, b in
                      zip(tree_leaves(on_mesh), want))
        placed = all(tuple(a.placements) == s.placements for a, s in
                     zip(tree_leaves(on_mesh), tree_leaves(sh)))
        ok_dev = all(torch.equal(a, b) and a.device.type == dev.type
                     for a, b in zip(tree_leaves(on_dev), want))
        print(f"18.2 elastic restore of a (1, 1) mesh checkpoint "
              f"({cfg.name}, {len(want)} leaves): onto the mesh bitwise "
              f"{ok_mesh} (placements {placed}), with device= alone bitwise "
              f"{ok_dev}; steps {step_m}, {step_d}")
        check(ok_mesh and placed and ok_dev and step_m == step_d == 1,
              "the elastic restore is not bitwise")
    finally:
        set_rules_profile("tp_fsdp")
        shutil.rmtree(ck, ignore_errors=True)


def mesh_dryrun_cell(arch: str, shape: str) -> dict:
    """18.3: one dry-run cell under this machine's torch on the
    single-pod (16, 16) mesh: a fake process group of 256 ranks, fake
    CUDA tensors (no card memory); the record's numbers are a projection
    from datasheet rates, not measurements."""
    from repro_torch.launch import dryrun

    out = os.path.join(HERE, "build", "chip_smoke", "dryrun")
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, "single", out, force=True,
                          device="cuda")
    secs = time.perf_counter() - t0
    check("error" not in rec, f"dry-run cell {arch} {shape} failed: "
          f"{rec.get('error')}\n{rec.get('traceback', '')[-2000:]}")
    r = rec["roofline"]
    print(f"18.3 dry run {arch} {shape}, single-pod 16 x 16 mesh "
          f"(PROJECTION from datasheet rates, {rec['hardware']}; not a "
          f"measurement): {secs:.1f} s (build {rec['seconds']['build']:.1f}"
          f" s, run {rec['seconds']['run']:.1f} s); per device: state "
          f"{rec['state_bytes_per_device'] / 2 ** 30:.3f} GiB, peak "
          f"{rec['hbm_bytes_per_device'] / 2 ** 30:.3f} GiB, "
          f"{rec['cost']['flops_per_device']:.4e} FLOP, "
          f"{rec['cost']['bytes_per_device']:.4e} bytes, wire "
          f"{rec['collectives']['wire_bytes']:.4e} bytes "
          f"{rec['collectives']['by_kind_count']}; roofline compute "
          f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
          f"ms, collective {r['collective_s'] * 1e3:.3f} ms, dominant "
          f"{r['dominant']}, MFU bound {r['mfu_bound']:.4f}")
    return rec


def mesh_phase(dev, seed: int, p17: dict) -> dict:
    """Phase 18: LM training on a DeviceMesh (18.1, 18.2 on a one-rank
    NCCL group; 18.3 on a fake group of 256; 18.4's trace runs last).
    The mesh path reaches none of the port's kernels: their launch counts
    must not move."""
    from repro_torch.launch.train import process_group

    before = kernel_launch_counts()
    out = {}
    t0 = time.perf_counter()
    with process_group(dev):
        out["step"] = mesh_train_step(dev, seed, p17)
        mesh_elastic_restore(dev, seed)
    print(f"18.1-18.2 mesh step and restore: {time.perf_counter() - t0:.1f} s")
    out["dryrun"] = {f"{a} {sh}": mesh_dryrun_cell(a, sh)
                     for a, sh in MESH_DRYRUN_CELLS}
    check(kernel_launch_counts() == before,
          "the mesh path launched one of the port's kernels")
    print(f"phase 18 launched none of the {len(before)} kernels")
    print("18 records: " + json.dumps(
        {"step": out["step"], "dryrun": {cell: {k: rec[k] for k in (
            "n_chips", "state_bytes_per_device", "hbm_bytes_per_device",
            "cost", "roofline", "seconds", "source")}
            for cell, rec in out["dryrun"].items()}}))
    return out


def mesh_train_trace(dev, seed: int, steps: int = 2) -> dict:
    """18.4: where one (1, 1) mesh step of 18.1 goes: wall ms (CUDA
    events) beside the device-busy ms torch.profiler records, the idle
    share and device kernels per step.  Run last, as 16.5 and 17.3."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import process_group
    from repro_torch.models.params import set_rules_profile
    from repro_torch.perf.trace import busy_us

    cfg = get_arch("olmo-1b")
    set_rules_profile(cfg.sharding_profile)
    try:
        with process_group(dev):
            model, step, state, batch, sh, bsh = _mesh_setup(cfg, dev, seed)
            box = [_placed(state, sh)]
            dbatch = {k: bsh[k].place(v) for k, v in batch.items()}
            del state

            def one():
                box[0], m = step(box[0], dbatch)
                float(m["loss"])

            one()
            wall_ms = statistics.median(event_ms(one, steps))
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    one()
                torch.cuda.synchronize(dev)
            del box, step, model, batch, dbatch
    finally:
        set_rules_profile("tp_fsdp")
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in on_dev]) / 1e3 / steps
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_kernels_per_step": len(on_dev) / steps}
    print(f"18.4 olmo-1b (1, 1) mesh train step: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{rec['device_idle_share']:.3f}), "
          f"{rec['device_kernels_per_step']:.1f} device kernels per step")
    check(len(on_dev) > 0, "the profiler saw no device work in a mesh step")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 19: the log-depth RG-LRU scan (recurrentgemma-9b)
# ---------------------------------------------------------------------------


def _rg_lru_inputs(dev, seed: int, seq: int, lru: dict, grad: bool):
    """19.1's inputs: one recurrent sublayer's RG-LRU weights (``lru``,
    f32) and an input of (1, seq, W) bf16 values from the seed, held as
    f32 (the scan upcasts its bf16 input first, so the forward is the
    same; the gradient of x is then not rounded to bf16, which would flip
    last bits between two summation orders).  With ``grad``, fresh leaves
    and the cotangents of y and h_last."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + seq)
    w = lru["lam"].shape[-1]
    x = torch.randn((1, seq, w), generator=g, device=dev).to(
        torch.bfloat16).float()
    if not grad:
        return x, lru, None
    p = {k: v.detach().clone().requires_grad_(k in RG_GRAD_KEYS)
         for k, v in lru.items()}
    cot = (torch.randn((1, seq, w), generator=g, device=dev),
           torch.randn((1, w), generator=g, device=dev))
    return x.requires_grad_(), p, cot


def _rg_lru_fwd_bwd(fn, x, p, cot) -> tuple:
    """y, h_last and the gradients of x and RG_GRAD_KEYS of ``fn``."""
    import torch

    y, h = fn(x, p)
    loss = (y * cot[0]).sum() + (h * cot[1]).sum()
    grads = torch.autograd.grad(loss, [x] + [p[k] for k in RG_GRAD_KEYS])
    return y, h, grads


def rglru_scan_part(lru: dict, dev, seed: int) -> dict:
    """19.1: ``rg_lru`` (the log-depth scan) against ``rg_lru_ref`` (the
    sequential loop) on one recurrent sublayer's weights at (1, S, 4096)
    for S in RG_SCAN_SEQS: outputs within SCAN_RTOL/SCAN_ATOL; at the
    first S also the gradients of x, w_a, w_x and lam; forward ms (and
    forward + backward ms at the first S) by CUDA events, median of
    RG_REPS after one untimed call, the two ways in turns."""
    import statistics

    import torch

    from repro_torch.models import rglru

    ways = {"scan": rglru.rg_lru, "sequential": rglru.rg_lru_ref}
    out = {}
    for seq in RG_SCAN_SEQS:
        rec = {}
        x, p, _ = _rg_lru_inputs(dev, seed, seq, lru, grad=False)
        with torch.no_grad():
            got = {k: fn(x, p) for k, fn in ways.items()}
            for i, what in enumerate(("y", "h_last")):
                a, b = got["scan"][i], got["sequential"][i]
                err = (a - b).abs().max().item()
                check(bool(torch.isfinite(a).all()),
                      f"19.1 S={seq}: non-finite {what}")
                check(torch.allclose(a, b, rtol=SCAN_RTOL, atol=SCAN_ATOL),
                      f"19.1 S={seq}: scan vs sequential {what}: max abs "
                      f"error {err:.3e}")
                rec[f"{what}_max_abs_err"] = err
            del got
            ms = {k: [] for k in ways}
            for _ in range(RG_REPS):
                for k, fn in ways.items():
                    ms[k] += event_ms(lambda: fn(x, p), 1)
        rec.update({f"{k}_fwd_ms": statistics.median(v)
                    for k, v in ms.items()})
        if seq == RG_SCAN_SEQS[0]:
            x, p, cot = _rg_lru_inputs(dev, seed, seq, lru, grad=True)
            res = {k: _rg_lru_fwd_bwd(fn, x, p, cot)
                   for k, fn in ways.items()}
            names = ("y", "h_last", "grad_x") + tuple(
                f"grad_{k}" for k in RG_GRAD_KEYS)
            flat = {k: (v[0], v[1]) + tuple(v[2]) for k, v in res.items()}
            for i, what in enumerate(names):
                a, b = flat["scan"][i], flat["sequential"][i]
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                check(torch.allclose(a, b, rtol=SCAN_RTOL, atol=SCAN_ATOL),
                      f"19.1 S={seq} fwd+bwd: scan vs sequential {what}: "
                      f"max abs error {err:.3e} (max |value| {scale:.3e})")
                rec[f"bwd_{what}_max_abs_err"] = err
            del res, flat
            ms = {k: [] for k in ways}
            for _ in range(RG_REPS):
                for k, fn in ways.items():
                    ms[k] += event_ms(lambda: _rg_lru_fwd_bwd(fn, x, p, cot),
                                      1)
            rec.update({f"{k}_fwd_bwd_ms": statistics.median(v)
                        for k, v in ms.items()})
        out[seq] = rec
        print(f"19.1 rg_lru (1, {seq}, {x.shape[-1]}), f32 on bf16 inputs: "
              f"forward scan {rec['scan_fwd_ms']:.3f} ms, sequential "
              f"{rec['sequential_fwd_ms']:.3f} ms (x"
              f"{rec['sequential_fwd_ms'] / rec['scan_fwd_ms']:.1f})"
              + (f"; forward + backward scan {rec['scan_fwd_bwd_ms']:.3f} "
                 f"ms, sequential {rec['sequential_fwd_bwd_ms']:.3f} ms (x"
                 f"{rec['sequential_fwd_bwd_ms'] / rec['scan_fwd_bwd_ms']:.1f}"
                 ")" if "scan_fwd_bwd_ms" in rec else "")
              + "; max abs errors " + ", ".join(
                  f"{k[:-12]} {v:.2e}" for k, v in rec.items()
                  if k.endswith("_max_abs_err")))
        del x, p
        torch.cuda.empty_cache()
    return out


def _prefill_logits(model, params, batch, lru_fn=None):
    """Last-position logits (f32) of one prefill, with ``lru_fn`` in place
    of ``rg_lru`` when given."""
    from repro_torch.models import rglru

    scan = rglru.rg_lru
    rglru.rg_lru = lru_fn or scan
    try:
        logits, _ = model.prefill(params, batch,
                                  cache_len=RG_PREFILL + RG_DECODE)
    finally:
        rglru.rg_lru = scan
    return logits.float()


def _one_ulp_off(scan):
    """``scan`` with each output entry moved by one f32 rounding step (a
    factor 1 +- 2^-24, signs from a fixed seed): how far the model's
    logits move for rounding alone."""
    import torch

    def fn(x, p, h0=None):
        y, h = scan(x, p, h0)
        g = torch.Generator(device=y.device).manual_seed(0)
        sign = torch.randint(0, 2, y.shape, generator=g,
                             device=y.device) * 2 - 1
        return y * (1 + sign * 2.0 ** -24), h

    return fn


def rglru_prefill_part(model, params, dev, seed: int) -> dict:
    """19.2 in the config's dtype (bf16): the full model's prefill of
    1 x RG_PREFILL tokens, ms per prefill (CUDA events, median of RG_REPS
    after one untimed), tokens/s, finite logits and RG_DECODE greedy
    decode steps; then the share of the largest |logit| by which the
    last-position logits move with ``rg_lru_ref`` patched in, beside the
    share they move when the scan's output is one f32 rounding step off
    (printed: bf16 rounding through 38 layers of random weights moves
    them by ~3e-2 either way, so the scan is held in f32, 19.2's
    ``rglru_prefill_f32``)."""
    import statistics

    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.models import rglru

    batch = model.make_batch(seed + 1, ShapeConfig(
        "rg_prefill", RG_PREFILL, 1, "prefill"), device=dev)
    cache_len = RG_PREFILL + RG_DECODE
    logits, caches = model.prefill(params, batch, cache_len=cache_len)
    check(bool(torch.isfinite(logits).all()), "19.2: a non-finite logit")
    ms = statistics.median(event_ms(
        lambda: model.prefill(params, batch, cache_len=cache_len), RG_REPS))
    tok = torch.argmax(logits, dim=-1)[:, None]
    toks = [tok]
    for _ in range(RG_DECODE):
        lg, caches = model.decode_step(params, caches, tok)
        check(bool(torch.isfinite(lg).all()),
              "19.2: a non-finite decode logit")
        tok = torch.argmax(lg, dim=-1)[:, None]
        toks.append(tok)
    toks = torch.cat(toks, dim=1)
    check(bool(((toks >= 0) & (toks < model.cfg.vocab_pad)).all()),
          "19.2: token ids outside the vocabulary")
    del caches
    logits = logits.float()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    seq = _prefill_logits(model, params, batch, rglru.rg_lru_ref)
    torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    off = _prefill_logits(model, params, batch,
                          _one_ulp_off(rglru.rg_lru))
    scale = seq.abs().max().item()
    rec = {"prefill_ms": ms, "tokens_per_s": RG_PREFILL / (ms / 1e3),
           "sequential_prefill_s": seq_s,
           "vs_sequential_share": (logits - seq).abs().max().item() / scale,
           "one_ulp_off_share": (logits - off).abs().max().item() / scale,
           "greedy_tokens": toks[0].tolist()}
    print(f"19.2 {model.cfg.name} prefill 1 x {RG_PREFILL} "
          f"({model.cfg.n_layers} layers, {model.cfg.dtype}): {ms:.3f} ms, "
          f"{rec['tokens_per_s']:.1f} tok/s; the same prefill with the "
          f"sequential scan patched in: {seq_s:.3f} s, last-position logits "
          f"{rec['vs_sequential_share']:.4e} of the largest |logit| "
          f"({scale:.4e}) from it; with the scan's output one f32 rounding "
          f"step off: {rec['one_ulp_off_share']:.4e}; greedy tokens "
          f"{rec['greedy_tokens']}")
    del seq, off, logits
    return rec


def rglru_prefill_f32(dev, seed: int) -> dict:
    """19.2 in f32 weights (the same widths and seed): the scan's
    last-position logits against the sequential scan's within
    RG_F32_FRAC of their largest |logit|."""
    import gc

    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models import rglru
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    batch = model.make_batch(seed + 1, ShapeConfig(
        "rg_prefill", RG_PREFILL, 1, "prefill"), device=dev)
    got = _prefill_logits(model, params, batch)
    want = _prefill_logits(model, params, batch, rglru.rg_lru_ref)
    check(bool(torch.isfinite(got).all()), "19.2 f32: a non-finite logit")
    scale = want.abs().max().item()
    share = (got - want).abs().max().item() / scale
    check(share <= RG_F32_FRAC,
          f"19.2 f32: scan vs sequential prefill logits differ by "
          f"{share:.4e} of the largest |logit| (allowed {RG_F32_FRAC})")
    print(f"19.2 {cfg.name} prefill 1 x {RG_PREFILL}, f32 weights: scan "
          f"vs sequential last-position logits {share:.4e} of the largest "
          f"|logit| ({scale:.4e}; allowed {RG_F32_FRAC})")
    del params, model, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32_vs_sequential_share": share}


def rglru_phase(dev, seed: int) -> dict:
    """Phase 19: recurrentgemma-9b at its published widths on the card:
    19.1 on its first recurrent sublayer's RG-LRU weights, then 19.2 with
    the full model in bf16 and in f32.  Reaches none of the port's
    kernels: their launch counts must not move.  The model not fitting,
    or any check, fails the run."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    before = kernel_launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(get_arch("recurrentgemma-9b"))
    params = model.init(seed, device=dev)
    lru = {k: params["blocks"]["rec"][k][0, 0].detach().clone()
           for k in ("w_a", "b_a", "w_x", "b_x", "lam")}
    out = {"lru": lru}
    t0 = time.perf_counter()
    out["scan"] = rglru_scan_part(lru, dev, seed)
    print(f"19.1 scan vs sequential: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["prefill"] = rglru_prefill_part(model, params, dev, seed)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill"].update(rglru_prefill_f32(dev, seed))
    print(f"19.2 prefill: {time.perf_counter() - t0:.1f} s")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(kernel_launch_counts() == before,
          "the RG-LRU path launched one of the port's kernels")
    print(f"phase 19 launched none of the {len(before)} kernels; peak "
          f"{out['peak_gib']:.2f} GiB")
    print("19 records: " + json.dumps(
        {"prefill": out["prefill"],
         "scan": {str(k): v for k, v in out["scan"].items()}}))
    return out


def rglru_launch_trace(lru: dict, dev, seed: int) -> dict:
    """19.1's launch counts: the device kernels torch.profiler records for
    one call each way (forward at every RG_SCAN_SEQS, forward + backward
    at the first).  Run last: after a session that recorded the
    sequential loop's 65k kernels, phase 10's profiler session on the
    card recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rglru

    ways = {"scan": rglru.rg_lru, "sequential": rglru.rg_lru_ref}
    counts = {}

    def kernels(fn) -> int:
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    for seq in RG_SCAN_SEQS:
        x, p, _ = _rg_lru_inputs(dev, seed, seq, lru, grad=False)
        with torch.no_grad():
            for k, fn in ways.items():
                counts[f"{k}_fwd_{seq}"] = kernels(lambda: fn(x, p))
        if seq == RG_SCAN_SEQS[0]:
            x, p, cot = _rg_lru_inputs(dev, seed, seq, lru, grad=True)
            for k, fn in ways.items():
                counts[f"{k}_fwd_bwd_{seq}"] = kernels(
                    lambda: _rg_lru_fwd_bwd(fn, x, p, cot))
        del x, p
        torch.cuda.empty_cache()
    print("19.1 device kernels per call (torch.profiler): " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    check(all(v > 0 for v in counts.values()),
          "the profiler saw no device work in an RG-LRU call")
    return counts


# ---------------------------------------------------------------------------
# Phase 20: the examples on the card
# ---------------------------------------------------------------------------


def run_example(name: str, argv: list) -> dict:
    """``main(argv)`` of ``examples/<name>_torch.py``, in-process, with
    every launch count zeroed just before and read just after; its printed
    lines echoed.  Returns its lines, the counts, the results of its
    ``cpapr_mu`` calls and its seconds (host clock, synchronised)."""
    import torch

    from repro_torch.testing.dist import example_checks

    path = os.path.join(HERE, "examples", f"{name}_torch.py")
    results = []
    reset_kernel_launch_counts()
    t0 = time.perf_counter()
    rc, lines = example_checks(0, 1, path, argv, results)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_launch_counts()
    for ln in lines:
        print(f"20   {ln}")
    check(rc == 0, f"examples/{name}_torch.py {argv} returned {rc}")
    return {"lines": lines, "launches": launches, "results": results,
            "seconds": secs}


def example_solve(what: str, run: dict, n_modes: int, card: str,
                  total: dict) -> None:
    """Hold an example's one CP-APR solve as phase 3 holds its own: B2
    once per mode update and B1 once per inner iteration, no other
    kernel, no demotion, finite nonnegative factors, a finite
    nondecreasing log-likelihood; print its ms per sweep (median over its
    sweeps) with the card.  Adds the counts read into ``total``."""
    import torch

    check(len(run["results"]) == 1,
          f"{what}: {len(run['results'])} cpapr_mu calls, expected 1")
    (res,) = run["results"]
    launches = run["launches"]
    print(f"{what}: {res.n_outer} sweeps, inner iterations "
          f"{res.inner_iters}, launches {launches}")
    check(res.recoveries is None,
          f"{what}: guard recoveries or demotions: {res.recoveries}")
    want = {"phi_blocked": res.n_outer * n_modes,
            "phi_mu_blocked": sum(res.inner_iters)}
    check(want["phi_mu_blocked"] > 0, f"{what}: no inner iteration")
    check(launches == {k: want.get(k, 0) for k in launches},
          f"{what}: expected {want} (B2 once per mode update, B1 once per "
          f"inner iteration, nothing else), launched {launches}")
    check(all(bool(torch.isfinite(f).all() and (f >= 0).all())
              for f in res.ktensor.factors),
          f"{what}: non-finite or negative factor")
    ll = res.loglik_history
    check(len(ll) == res.n_outer and all(math.isfinite(x) for x in ll)
          and monotone(ll),
          f"{what}: log-likelihood not finite and nondecreasing: {ll}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    sweep_ms = 1e3 * sorted(res.sweep_seconds)[len(res.sweep_seconds) // 2]
    print(f"{what}: {run['seconds']:.2f} s, {res.n_outer} sweeps at "
          f"{sweep_ms:.3f} ms per sweep (median; {card})")


def example_serve(dev, width: list, card: str) -> None:
    """serve_lm at its defaults, given ``width`` (``[]``: the reduced
    preset, a smoke run whose rate is no metric; ``["--full"]``: the
    published width in bf16): its tokens, tok/s on its own clock, no
    kernel launched."""
    run = run_example("serve_lm", ["--device", dev.type] + width)
    head = run["lines"][0]
    check(not any(run["launches"].values()),
          f"serve_lm {width} launched one of the port's kernels: "
          f"{run['launches']}")
    arch = "h2o-danube-1.8b" + ("" if width else "-smoke")
    check(head.startswith(f"[serve] arch={arch} ")
          and "generated (4, 32) tokens" in head,
          f"serve_lm {width}: {head}")
    m = re.search(r"\(([\d.]+) tok/s", head)
    check(m is not None, f"serve_lm: no tok/s in {head}")
    kind = ("published width, bf16" if width
            else "reduced preset: smoke only, not a metric")
    print(f"20.3 {' '.join(['serve_lm'] + width)} ({kind}): "
          f"{run['seconds']:.2f} s, {m.group(1)} tok/s (its own clock, first generate; {card}); "
          f"launched none of the {len(run['launches'])} kernels")


def example_train(dev, width: list, card: str) -> None:
    """train_lm given ``width`` (as :func:`example_serve`), ``--steps``
    EXAMPLE_TRAIN_STEPS in turn on one fresh checkpoint directory under
    ``build/chip_smoke/``: each run resumes at the last one's step, every
    loss finite, no kernel launched; ms per step on its own clock."""
    import shutil

    import torch

    ck = os.path.join(HERE, "build", "chip_smoke", "example_train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    arch = "olmo-1b" + ("" if width else "-smoke")
    kind = ("published width, bf16" if width
            else "reduced preset: smoke only, not a metric")
    try:
        start = 0
        for steps in EXAMPLE_TRAIN_STEPS:
            run = run_example("train_lm", ["--device", dev.type] + width
                              + ["--steps", str(steps), "--ckpt-dir", ck])
            lines = run["lines"]
            check(lines[0].startswith(f"[train] arch={arch} ")
                  and lines[0].endswith(f"start_step={start}"),
                  f"train_lm {width} --steps {steps}: expected {arch} at "
                  f"start_step={start}: {lines[0]}")
            check(lines[-1].startswith(f"[train] done at step {steps}"),
                  f"train_lm --steps {steps}: {lines[-1]}")
            steps_run = [ln.split() for ln in lines
                         if ln.startswith("[train] step")]
            check([int(s[2]) for s in steps_run]
                  == list(range(start + 1, steps + 1)),
                  f"train_lm --steps {steps}: step lines {steps_run}")
            check(all(math.isfinite(float(s[4])) for s in steps_run),
                  f"train_lm: a loss is not finite: {steps_run}")
            check(not any(run["launches"].values()),
                  f"train_lm launched one of the port's kernels: "
                  f"{run['launches']}")
            ms = sorted(float(s[-1].removesuffix("ms"))
                        for s in steps_run[1:])
            print(f"20.4 {' '.join(['train_lm'] + width)} --steps {steps} "
                  f"(start {start}; {kind}): {run['seconds']:.2f} s, "
                  f"{ms[len(ms) // 2]:.0f} ms per step (median after the "
                  f"first, its own clock; {card})")
            start = steps
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.empty_cache()


def examples_phase(dev, card: str) -> dict:
    """Phase 20: the four examples (``examples/*_torch.py``) through their
    ``main`` on the card.  Returns the CP examples' launch counts summed."""
    import torch

    d = ["--device", dev.type]
    total = {}
    run = run_example("quickstart", d)
    check(run["lines"][1] == "Phi strategy: cuda",
          f"quickstart: {run['lines'][1]}")
    example_solve("20.1 quickstart", run, 3, card, total)

    for scale in EXAMPLE_FROSTT_SCALES:
        run = run_example("decompose_frostt",
                          d + ["--tensor", "uber", "--scale", str(scale)])
        check(run["lines"][1].startswith(
            "heuristic policy for this platform: cuda:"),
            f"decompose_frostt: the heuristic did not pick the Φ kernel on "
            f"the card: {run['lines'][1]}")
        example_solve(f"20.2 decompose_frostt --tensor uber --scale {scale}",
                      run, 4, card, total)
        torch.cuda.empty_cache()

    for width in ([], ["--full"]):
        example_serve(dev, width, card)
        torch.cuda.empty_cache()
    for width in ([], ["--full"]):
        example_train(dev, width, card)
    return total


def monotone(ll: list) -> bool:
    return all(b >= a - MONOTONE_SLACK * abs(a) for a, b in zip(ll, ll[1:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="uber", choices=("uber", "nell2"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    init = random_ktensor(args.seed, t.shape, RANK,
                          device=dev).normalize()
    mvs = [sort_mode(t, n) for n in range(t.ndim)]
    pol = default_policy(RANK)
    layouts = [build_blocked_layout(mv.rows, mv.n_rows,
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
    dinit = random_ktensor(args.seed, dt.shape, RANK,
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

    # --- phase 16: LM serving ----------------------------------------------
    t0 = time.perf_counter()
    lm_phase(dev, args.seed)
    print(f"phase 16 (LM serving): {time.perf_counter() - t0:.1f} s")

    # --- phase 17: LM training ---------------------------------------------
    t0 = time.perf_counter()
    p17 = train_phase(dev, args.seed)
    print(f"phase 17 (LM training): {time.perf_counter() - t0:.1f} s")

    # --- phase 18: LM training on a DeviceMesh -----------------------------
    t0 = time.perf_counter()
    mesh_phase(dev, args.seed, p17["olmo"])
    print(f"phase 18 (mesh training): {time.perf_counter() - t0:.1f} s")

    # --- phase 19: the log-depth RG-LRU scan -------------------------------
    t0 = time.perf_counter()
    p19 = rglru_phase(dev, args.seed)
    print(f"phase 19 (RG-LRU scan): {time.perf_counter() - t0:.1f} s")

    # --- phase 20: the examples on the card --------------------------------
    t0 = time.perf_counter()
    example_launches = examples_phase(dev, card)
    print(f"phase 20 (examples): {time.perf_counter() - t0:.1f} s")

    # --- 16.5 and 17.3: the traces (the profiler's set-up slows the host) --
    t0 = time.perf_counter()
    lm_decode_trace(dev, args.seed)
    print(f"16.5 decode-step trace: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_train_trace(dev, args.seed)
    print(f"17.3 train-step trace: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_train_trace(dev, args.seed)
    print(f"18.4 mesh train-step trace: {time.perf_counter() - t0:.1f} s")

    # --- phase 10: one launch per fused dense step ------------------------
    one_launch_phase(*dense_first)

    # --- 19.1's launch counts (last: see rglru_launch_trace) ---------------
    t0 = time.perf_counter()
    rglru_launch_trace(p19["lru"], dev, args.seed)
    print(f"19.1 launch-count trace: {time.perf_counter() - t0:.1f} s")

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
         "example_launches": example_launches.get(k, 0),
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
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
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
