"""Blocked segmented layout: the static schedule the Φ kernels run on.

The paper's CPU algorithm (Alg. 4) sorts nonzeros per mode so same-row
updates are contiguous, then uses atomics only at thread-boundary rows.
The blocked layout makes that schedule static:

  * rows are grouped into row blocks of ``block_rows``;
  * the sorted nonzero stream is padded so that every ``block_nnz``
    chunk of nonzeros (one grid step) touches exactly one row block;
  * ``grid_rb`` maps grid step -> row block (non-decreasing).

Row blocks with zero nonzeros still get one (all-padding) grid step, and
inside each grid step the valid slots form a prefix (padding sits at the
tail of its row block).  The CUDA kernels rely on both facts.

``build_blocked_layout`` runs on host numpy once per mode, and its arrays
are equal, element for element, to the JAX package's
``repro.core.layout``; the device copies the kernels read are made once
per layout and device (:meth:`BlockedLayout.on`).

The row-sharded (1-D) multi-device tier partitions a blocked layout into
contiguous row-block shards (:class:`ShardedBlockedLayout`,
:func:`shard_blocked_layout`, :func:`rebalance_shards`), assigns each
shard ownership of its window of the combine buffer
(:class:`OwnerPartition`) and maps each shard's nonzeros to the factor
rows they touch (:class:`ShardedPiGather`).  The N-D grid tier refines
a row-shard split over an ``A x B`` device grid (:class:`GridLayout`,
:func:`build_grid_layout`, :func:`choose_grid_shape`): each shard's
nonzero stream is cut into ``B`` cells.  All host numpy, array-equal to
the JAX package's.
"""
from __future__ import annotations

import dataclasses
import weakref
import zlib
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "BlockedLayout",
    "GridLayout",
    "LayoutTensors",
    "ModeStats",
    "OwnerPartition",
    "ShardedBlockedLayout",
    "ShardedPiGather",
    "build_blocked_layout",
    "build_grid_layout",
    "build_shard_pi_gather",
    "choose_grid_shape",
    "fill_stats",
    "grid_factor_pairs",
    "mode_run_stats",
    "owner_partition",
    "pad_rows",
    "rebalance_shards",
    "round_up",
    "shard_blocked_layout",
    "shard_row_ranges",
    "shard_stream_cuts",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(b: torch.Tensor, n_rows_pad: int) -> torch.Tensor:
    """``b`` (n_rows, R) zero-padded to ``n_rows_pad`` rows, contiguous:
    the B window a layout's kernels and emulation read."""
    extra = n_rows_pad - b.shape[0]
    if extra == 0:
        return b.contiguous()
    return torch.cat([b, b.new_zeros((extra, b.shape[1]))])


# ---------------------------------------------------------------------------
# Per-mode segment-run statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModeStats:
    """Segment-run statistics of one mode's sorted nonzero stream.

      p95_run:    95th percentile nonzeros-per-row over nonempty rows.
      dup_share:  max nonzeros in any single row / nnz (hub dominance).
      empty_frac: fraction of rows with zero nonzeros.
      fill_frac:  nnz / (n_rows * row_width), or -1.0 when unknown.

    The ``*_bin`` fields are the coarse buckets the policy heuristic and
    autotune keys read: ``p95_bin`` = floor(log2(p95_run)), ``dup_bin`` =
    floor(-log2(dup_share)) capped at 16, ``empty_bin`` =
    floor(4 * empty_frac) in 0..3, ``fill_bin`` = floor(-log2(fill_frac))
    capped at 15 (-1 when unknown).
    """

    nnz: int
    n_rows: int
    p95_run: float
    max_run: int
    dup_share: float
    empty_frac: float
    p95_bin: int
    dup_bin: int
    empty_bin: int
    fill_frac: float = -1.0
    fill_bin: int = -1

    DUP_BIN_CAP = 16
    FILL_BIN_CAP = 15

    def key_fragment(self) -> str:
        """The binned-stats dimension of an autotune cache key."""
        frag = f"p95=b{self.p95_bin}/dup=b{self.dup_bin}/emt=b{self.empty_bin}"
        if self.fill_bin >= 0:
            frag += f"/fill=b{self.fill_bin}"
        return frag


def fill_stats(nnz: int, n_rows: int, row_width: int) -> tuple:
    """(fill_frac, fill_bin) of a mode with ``row_width`` cells per row."""
    cells = max(int(n_rows), 1) * max(int(row_width), 1)
    fill = nnz / cells
    if fill <= 0.0:
        return 0.0, ModeStats.FILL_BIN_CAP
    fill_bin = int(np.clip(np.floor(-np.log2(fill)), 0,
                           ModeStats.FILL_BIN_CAP))
    return float(fill), fill_bin


def mode_run_stats(
    rows_sorted: np.ndarray, n_rows: int, row_width: int | None = None
) -> ModeStats:
    """Segment-run statistics from sorted mode-n coordinates (host numpy).

    Handles nnz=0 (all stats zero, maximally-empty bins).  ``row_width``
    (the product of the other mode dimensions) fills the fill-fraction
    fields; without it they stay unknown.
    """
    rows_sorted = np.asarray(rows_sorted)
    nnz = int(rows_sorted.shape[0])
    n_rows = int(n_rows)
    fill_frac, fill_bin = -1.0, -1
    if row_width is not None:
        fill_frac, fill_bin = fill_stats(nnz, n_rows, row_width)
    if nnz == 0:
        return ModeStats(
            nnz=0, n_rows=n_rows, p95_run=0.0, max_run=0, dup_share=0.0,
            empty_frac=1.0, p95_bin=0, dup_bin=ModeStats.DUP_BIN_CAP,
            empty_bin=3, fill_frac=fill_frac, fill_bin=fill_bin,
        )
    counts = np.bincount(rows_sorted, minlength=max(n_rows, 1))
    runs = counts[counts > 0]
    p95 = float(np.percentile(runs, 95))
    max_run = int(runs.max())
    dup_share = max_run / nnz
    empty_frac = 1.0 - runs.size / max(n_rows, 1)
    p95_bin = int(np.floor(np.log2(max(p95, 1.0))))
    dup_bin = int(min(np.floor(-np.log2(dup_share)), ModeStats.DUP_BIN_CAP))
    empty_bin = int(np.clip(np.floor(4.0 * empty_frac), 0, 3))
    return ModeStats(
        nnz=nnz, n_rows=n_rows, p95_run=p95, max_run=max_run,
        dup_share=float(dup_share), empty_frac=float(empty_frac),
        p95_bin=p95_bin, dup_bin=dup_bin, empty_bin=empty_bin,
        fill_frac=fill_frac, fill_bin=fill_bin,
    )


@dataclasses.dataclass(frozen=True)
class LayoutTensors:
    """Device copies of a layout's index arrays (what the kernels read);
    a sharded layout's carry a leading shard axis."""

    gather: torch.Tensor  # (n_grid*block_nnz,) int64
    valid: torch.Tensor  # (n_grid*block_nnz,) bool
    local_rows: torch.Tensor  # (n_grid*block_nnz,) int32
    grid_rb: torch.Tensor  # (n_grid,) int32


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedLayout:
    """Static schedule for a blocked segmented reduction.

    Attributes:
      block_nnz:   nonzeros per grid step.
      block_rows:  rows of B/Φ per row block.
      n_rows:      true number of rows I_n.
      n_rows_pad:  I_n padded to a multiple of block_rows.
      n_grid:      number of grid steps.
      gather:      (n_grid*block_nnz,) int64 indices into the *sorted*
                   nonzero stream; padding slots point at 0.
      valid:       (n_grid*block_nnz,) bool, False for padding slots.
      local_rows:  (n_grid*block_nnz,) int32 row index *within* the row
                   block (padding slots -> 0).
      grid_rb:     (n_grid,) int32 row block per grid step (non-decreasing).
      pad_fraction: padding overhead.
    """

    block_nnz: int
    block_rows: int
    n_rows: int
    n_rows_pad: int
    n_grid: int
    gather: np.ndarray
    valid: np.ndarray
    local_rows: np.ndarray
    grid_rb: np.ndarray
    pad_fraction: float
    # device copies, made once per device by on(); the dict is mutated in
    # place so the frozen layout can cache them
    _device_copies: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def n_row_blocks(self) -> int:
        return self.n_rows_pad // self.block_rows

    def on(self, device) -> LayoutTensors:
        """The layout's index arrays as tensors on ``device`` (cached)."""
        return _layout_tensors(self, device)


def _layout_tensors(layout, device) -> LayoutTensors:
    """``layout``'s gather/valid/local_rows/grid_rb arrays (flat, or
    stacked per shard) as tensors on ``device``, made once per device."""
    device = torch.device(device)
    key = str(device)
    lt = layout._device_copies.get(key)
    if lt is None:
        lt = LayoutTensors(
            gather=torch.as_tensor(layout.gather, dtype=torch.int64,
                                   device=device),
            valid=torch.as_tensor(layout.valid, device=device),
            local_rows=torch.as_tensor(layout.local_rows, dtype=torch.int32,
                                       device=device),
            grid_rb=torch.as_tensor(layout.grid_rb, dtype=torch.int32,
                                    device=device),
        )
        layout._device_copies[key] = lt
    return lt


def build_blocked_layout(
    rows_sorted: np.ndarray, n_rows: int, block_nnz: int, block_rows: int
) -> BlockedLayout:
    """Build the static schedule from sorted mode-n coordinates.

    Args:
      rows_sorted: (nnz,) ascending mode-n coordinates.
      n_rows: I_n.
      block_nnz / block_rows: the parallel policy (paper's vector/team).
    """
    rows_sorted = np.asarray(rows_sorted)
    if rows_sorted.size and not np.all(np.diff(rows_sorted) >= 0):
        raise ValueError("rows_sorted must be ascending (use ModeView.rows)")
    nnz = int(rows_sorted.shape[0])
    n_rows_pad = round_up(max(n_rows, block_rows), block_rows)
    n_rb = n_rows_pad // block_rows

    rb_of_nnz = rows_sorted // block_rows
    counts = np.bincount(rb_of_nnz, minlength=n_rb)

    gather_parts = []
    valid_parts = []
    lrow_parts = []
    grid_rb_parts = []
    start = 0
    for rb in range(n_rb):
        c = int(counts[rb])
        c_pad = max(round_up(c, block_nnz), block_nnz)  # >=1 grid step per rb
        g = np.zeros(c_pad, dtype=np.int64)
        v = np.zeros(c_pad, dtype=bool)
        g[:c] = np.arange(start, start + c)
        v[:c] = True
        lr = np.zeros(c_pad, dtype=np.int32)
        lr[:c] = rows_sorted[start : start + c] - rb * block_rows
        gather_parts.append(g)
        valid_parts.append(v)
        lrow_parts.append(lr)
        grid_rb_parts.append(np.full(c_pad // block_nnz, rb, dtype=np.int32))
        start += c

    gather = np.concatenate(gather_parts) if gather_parts else np.zeros(0, np.int64)
    valid = np.concatenate(valid_parts) if valid_parts else np.zeros(0, bool)
    local_rows = np.concatenate(lrow_parts) if lrow_parts else np.zeros(0, np.int32)
    grid_rb = np.concatenate(grid_rb_parts) if grid_rb_parts else np.zeros(0, np.int32)
    n_grid = int(grid_rb.shape[0])
    total = n_grid * block_nnz
    pad_fraction = 0.0 if nnz == 0 else 1.0 - nnz / max(total, 1)

    return BlockedLayout(
        block_nnz=block_nnz,
        block_rows=block_rows,
        n_rows=n_rows,
        n_rows_pad=n_rows_pad,
        n_grid=n_grid,
        gather=gather,
        valid=valid,
        local_rows=local_rows,
        grid_rb=grid_rb,
        pad_fraction=float(pad_fraction),
    )


# ---------------------------------------------------------------------------
# Row-sharded blocked schedule (the 1-D multi-device tier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBlockedLayout:
    """Blocked schedule partitioned into contiguous row-block shards.

    ``grid_rb`` of the base layout is non-decreasing, so a contiguous row
    block range owns a contiguous slice of the grid-step stream: each
    shard is itself a valid (smaller) blocked schedule over its local row
    window.  Every per-shard array is padded to one uniform shape, so the
    same kernel launch shape serves every shard, and one combine (an
    all-reduce or a reduce-scatter over the shards) sums the per-shard
    partial windows.

    Attributes:
      base:         the unsharded global :class:`BlockedLayout`.
      n_shards:     number of shards (the mesh's data-axis size).
      n_grid_shard: uniform grid steps per shard (max over shards, padded).
      n_rb_shard:   uniform row blocks per shard (max over shards, padded).
      buf_rows:     rows of the combine buffer: >= n_rows_pad, sized so the
                    highest shard window fits without index clamping.
      rb_start:     (S,) int32 first global row block of each shard.
      rb_count:     (S,) int32 real (unpadded) row blocks per shard.
      shard_nnz:    (S,) int64 real nonzeros per shard (balance metric).
      gather:       (S, n_grid_shard*block_nnz) int64 into the sorted stream.
      valid:        (S, n_grid_shard*block_nnz) bool; False for padding.
      local_rows:   (S, n_grid_shard*block_nnz) int32 row within row block.
      grid_rb:      (S, n_grid_shard) int32 *shard-local* row block per grid
                    step (non-decreasing, in [0, n_rb_shard)).
      pad_fraction: overall padding overhead across all shards.
    """

    base: BlockedLayout
    n_shards: int
    n_grid_shard: int
    n_rb_shard: int
    buf_rows: int
    rb_start: np.ndarray
    rb_count: np.ndarray
    shard_nnz: np.ndarray
    gather: np.ndarray
    valid: np.ndarray
    local_rows: np.ndarray
    grid_rb: np.ndarray
    pad_fraction: float
    _device_copies: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def block_nnz(self) -> int:
        return self.base.block_nnz

    @property
    def block_rows(self) -> int:
        return self.base.block_rows

    @property
    def n_rows(self) -> int:
        return self.base.n_rows

    @property
    def n_rows_pad(self) -> int:
        return self.base.n_rows_pad

    @property
    def win_rows(self) -> int:
        """Rows of one shard's padded output window."""
        return self.n_rb_shard * self.block_rows

    def combine_bytes(self, rank: int, itemsize: int = 4) -> int:
        """Bytes of one per-device combine buffer (the all-reduce operand)."""
        return self.buf_rows * rank * itemsize

    def on(self, device) -> LayoutTensors:
        """The stacked (S, ...) index arrays as tensors on ``device``
        (cached)."""
        return _layout_tensors(self, device)


def _split_row_blocks(weight_per_rb: np.ndarray, n_shards: int) -> list:
    """Contiguous row-block boundaries balancing ``weight_per_rb`` per shard
    (grid steps for the static split, nonzeros or measured seconds per
    nonzero for the rebalanced one)."""
    n_rb = int(weight_per_rb.shape[0])
    cum = np.cumsum(weight_per_rb.astype(np.float64))
    total = float(cum[-1])
    bounds = [0]
    for s in range(1, n_shards):
        j = int(np.searchsorted(cum, total * s / n_shards))
        j = max(j, bounds[-1] + 1)  # every shard owns >= 1 row block
        j = min(j, n_rb - (n_shards - s))  # leave room for later shards
        bounds.append(j)
    bounds.append(n_rb)
    return bounds


def shard_blocked_layout(
    layout: BlockedLayout, n_shards: int, bounds: "Sequence[int] | None" = None
) -> ShardedBlockedLayout:
    """Partition a blocked layout into ``n_shards`` contiguous row-block shards.

    ``bounds`` (optional) is an explicit row-block boundary list of length
    ``n_shards + 1`` (``bounds[s]:bounds[s+1]`` is shard ``s``'s range); by
    default the split balances *grid steps* per shard.  Raises
    ``ValueError`` when ``n_shards`` exceeds the number of row blocks
    (each shard must own at least one).
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_rb = layout.n_row_blocks
    if n_shards > n_rb:
        raise ValueError(
            f"n_shards={n_shards} exceeds n_row_blocks={n_rb}; "
            "use a smaller block_rows or fewer shards"
        )
    bn = layout.block_nnz
    steps_per_rb = np.bincount(layout.grid_rb, minlength=n_rb)
    if bounds is None:
        bounds = _split_row_blocks(steps_per_rb, n_shards)
    else:
        bounds = [int(x) for x in bounds]
        if (
            len(bounds) != n_shards + 1
            or bounds[0] != 0
            or bounds[-1] != n_rb
            or any(b <= a for a, b in zip(bounds, bounds[1:]))
        ):
            raise ValueError(
                f"bounds must be strictly increasing from 0 to {n_rb} with "
                f"{n_shards + 1} entries, got {bounds}"
            )

    rb_start = np.asarray(bounds[:-1], np.int32)
    rb_count = np.diff(np.asarray(bounds, np.int64)).astype(np.int32)
    step_starts = np.concatenate([[0], np.cumsum(steps_per_rb)])
    shard_steps = [
        int(step_starts[bounds[s + 1]] - step_starts[bounds[s]])
        for s in range(n_shards)
    ]
    n_rb_shard = int(rb_count.max())
    # every padded (never-owned) local row block still gets one all-dummy
    # grid step, so kernel output windows are always initialized
    n_grid_shard = max(
        shard_steps[s] + (n_rb_shard - int(rb_count[s])) for s in range(n_shards)
    )

    slot = n_grid_shard * bn
    gather = np.zeros((n_shards, slot), np.int64)
    valid = np.zeros((n_shards, slot), bool)
    local_rows = np.zeros((n_shards, slot), np.int32)
    grid_rb = np.zeros((n_shards, n_grid_shard), np.int32)
    shard_nnz = np.zeros(n_shards, np.int64)

    for s in range(n_shards):
        g0 = int(step_starts[bounds[s]])
        g1 = int(step_starts[bounds[s + 1]])
        nsteps = g1 - g0
        sl = slice(g0 * bn, g1 * bn)
        gather[s, : nsteps * bn] = layout.gather[sl]
        valid[s, : nsteps * bn] = layout.valid[sl]
        local_rows[s, : nsteps * bn] = layout.local_rows[sl]
        rb_local = layout.grid_rb[g0:g1] - bounds[s]
        # dummy visits to padded row blocks, then trailing pad at the last
        # local block: keeps grid_rb non-decreasing
        tail = np.arange(int(rb_count[s]), n_rb_shard, dtype=np.int32)
        pad_steps = n_grid_shard - nsteps - tail.size
        grid_rb[s] = np.concatenate(
            [rb_local, tail, np.full(pad_steps, n_rb_shard - 1, np.int32)]
        )
        shard_nnz[s] = int(np.count_nonzero(valid[s]))

    br = layout.block_rows
    buf_rows = max(
        layout.n_rows_pad,
        int((rb_start + n_rb_shard).max()) * br,
    )
    nnz = int(shard_nnz.sum())
    total_slots = n_shards * slot
    pad_fraction = 0.0 if nnz == 0 else 1.0 - nnz / max(total_slots, 1)

    return ShardedBlockedLayout(
        base=layout,
        n_shards=n_shards,
        n_grid_shard=n_grid_shard,
        n_rb_shard=n_rb_shard,
        buf_rows=buf_rows,
        rb_start=rb_start,
        rb_count=rb_count,
        shard_nnz=shard_nnz,
        gather=gather,
        valid=valid,
        local_rows=local_rows,
        grid_rb=grid_rb,
        pad_fraction=float(pad_fraction),
    )


def _nnz_per_row_block(layout: BlockedLayout) -> np.ndarray:
    """(n_row_blocks,) real nonzeros owned by each row block."""
    valid_per_step = layout.valid.reshape(layout.n_grid, layout.block_nnz).sum(
        axis=1
    )
    return np.bincount(
        layout.grid_rb,
        weights=valid_per_step.astype(np.float64),
        minlength=layout.n_row_blocks,
    )


def rebalance_shards(
    slayout: ShardedBlockedLayout,
    shard_seconds: "Sequence[float] | None" = None,
) -> ShardedBlockedLayout:
    """Re-split a sharded layout's row-block boundaries by measured cost.

    The static split balances *grid steps*, which over-weights padding: a
    hub-dominated shard can own far more real nonzeros than its step count
    suggests.  ``shard_seconds=None`` weights each row block by its real
    nonzero count; given per-shard seconds, each row block is weighted by
    ``nnz * seconds_per_nnz(current owner)``, so a slow shard sheds row
    blocks.  The base layout is untouched, so every new shard is still a
    contiguous run of the base schedule.  Returns a new layout with the
    same shard count (equal to the input when already balanced).
    """
    base = slayout.base
    n_shards = slayout.n_shards
    weights = _nnz_per_row_block(base)
    if shard_seconds is not None:
        shard_seconds = np.asarray(shard_seconds, np.float64)
        if shard_seconds.shape != (n_shards,):
            raise ValueError(
                f"shard_seconds must have shape ({n_shards},), "
                f"got {shard_seconds.shape}"
            )
        if np.any(shard_seconds < 0):
            raise ValueError("shard_seconds must be non-negative")
        per_nnz = shard_seconds / np.maximum(
            slayout.shard_nnz.astype(np.float64), 1.0
        )
        owner = np.repeat(np.arange(n_shards), slayout.rb_count)
        weights = weights * per_nnz[owner]
    if weights.sum() <= 0.0:
        # degenerate (nnz=0 or all-zero times): keep the step-balanced split
        weights = np.bincount(
            base.grid_rb, minlength=base.n_row_blocks
        ).astype(np.float64)
    bounds = _split_row_blocks(weights, n_shards)
    return shard_blocked_layout(base, n_shards, bounds=bounds)


def shard_row_ranges(slayout: ShardedBlockedLayout) -> list:
    """Per-shard global ``(row_lo, row_hi)`` half-open row ranges, clipped
    to the true row count (so they cover ``[0, n_rows)`` exactly)."""
    br = slayout.block_rows
    n_rows = slayout.n_rows
    out = []
    for s in range(slayout.n_shards):
        lo = min(int(slayout.rb_start[s]) * br, n_rows)
        hi = min(int(slayout.rb_start[s] + slayout.rb_count[s]) * br, n_rows)
        out.append((lo, hi))
    return out


def shard_stream_cuts(
    slayout: ShardedBlockedLayout, rows_sorted: np.ndarray
) -> list:
    """Sorted-stream cut positions matching the layout's shard assignment:
    ``cuts[s]:cuts[s+1]`` is shard ``s``'s slice of the sorted nonzero
    stream (the sub-problems the autotuner keys on)."""
    rows_sorted = np.asarray(rows_sorted)
    br = slayout.block_rows
    cuts = [0]
    for s in range(1, slayout.n_shards):
        cuts.append(int(np.searchsorted(rows_sorted,
                                        int(slayout.rb_start[s]) * br)))
    cuts.append(int(rows_sorted.shape[0]))
    return cuts


# ---------------------------------------------------------------------------
# Owner partition: row ownership for the reduce-scatter combine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class OwnerPartition:
    """Row-owner partition of the combine window for reduce-scatter.

    Each shard *owns* its own padded row window of the ``(buf_rows, R)``
    combine buffer, so the combine can be a reduce-scatter: each device
    keeps only its owned O(I_n * R / S) slice, runs the MU/KKT epilogue
    on owned rows, and the updated factor rows are gathered once per mode
    update.  Owner ``s`` owns rows ``[row_start[s], row_start[s] +
    row_count[s])``, the window's trailing padding going to the last
    owner; ``own_rows`` is the uniform padded slice width and rows past
    ``row_count[s]`` inside a slice are masked to zero (they belong to
    the next owner).

    Attributes:
      n_shards:  owner count S (== the layout's shard count).
      own_rows:  uniform padded rows per owner slice.
      buf_rows:  rows of the combine window (``row_start[-1] + own_rows``).
      n_rows:    true row count I_n.
      row_start: (S,) int64 first owned row of each owner.
      row_count: (S,) int64 really-owned rows (summing to buf_rows).
      rb_start:  the owning layout's shard assignment (its ``rb_start`` as
                 a tuple); consumers check it before use.
    """

    n_shards: int
    own_rows: int
    buf_rows: int
    n_rows: int
    row_start: np.ndarray
    row_count: np.ndarray
    rb_start: tuple
    _device_copies: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def fingerprint(self) -> str:
        """crc32 of the shard assignment, in the autotuner's ``/assign=``
        fragment style (stable across processes)."""
        arr = np.asarray(self.rb_start, np.int64)
        return format(zlib.crc32(arr.tobytes()) & 0xFFFFFFFF, "08x")

    def masks(self) -> np.ndarray:
        """(S, own_rows) bool: True on really-owned rows of each slice."""
        return (
            np.arange(self.own_rows)[None, :]
            < self.row_count[:, None]
        )

    def masks_on(self, device) -> torch.Tensor:
        """:meth:`masks` as a bool tensor on ``device`` (cached, so a
        captured CUDA graph copies nothing from the host)."""
        device = torch.device(device)
        m = self._device_copies.get(str(device))
        if m is None:
            m = torch.as_tensor(self.masks(), device=device)
            self._device_copies[str(device)] = m
        return m

    def owner_of_rows(self) -> np.ndarray:
        """(buf_rows,) int32 owner of every combine-window row."""
        return np.repeat(
            np.arange(self.n_shards, dtype=np.int32), self.row_count
        )

    def scatter_bytes(self, rank: int, itemsize: int = 4) -> int:
        """Bytes of one per-device reduce-scatter output (the owned slice)."""
        return self.own_rows * rank * itemsize


# one partition per layout object, so callers that resolve it per call
# share it; weak keys let rebalanced (abandoned) layouts free theirs
_OWNER_PARTITIONS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def owner_partition(slayout: ShardedBlockedLayout) -> OwnerPartition:
    """The owner partition matching a sharded layout's row cuts (memoized
    per layout object).  Each owner's slice is its shard's padded row
    window, so a shard's local partial window *is* its contribution to
    its own slot of the reduce-scatter operand: its contributions to
    other owners' slots are exactly zero."""
    cached = _OWNER_PARTITIONS.get(slayout)
    if cached is not None:
        return cached
    opart = _build_owner_partition(slayout)
    _OWNER_PARTITIONS[slayout] = opart
    return opart


def _build_owner_partition(slayout: ShardedBlockedLayout) -> OwnerPartition:
    br = slayout.block_rows
    own_rows = slayout.n_rb_shard * br
    row_start = slayout.rb_start.astype(np.int64) * br
    row_count = slayout.rb_count.astype(np.int64) * br
    # trailing window padding belongs to the last owner: the buf_rows
    # window always ends exactly one padded slice after the last cut
    if int(row_start[-1]) + own_rows != slayout.buf_rows:
        raise AssertionError(
            f"combine window ends at {slayout.buf_rows}, expected "
            f"{int(row_start[-1]) + own_rows} (layout invariant violated)"
        )
    row_count = row_count.copy()
    row_count[-1] = slayout.buf_rows - int(row_start[-1])
    return OwnerPartition(
        n_shards=slayout.n_shards,
        own_rows=own_rows,
        buf_rows=slayout.buf_rows,
        n_rows=slayout.n_rows,
        row_start=row_start,
        row_count=row_count,
        rb_start=tuple(int(x) for x in slayout.rb_start),
    )


# ---------------------------------------------------------------------------
# N-D grid layout: nonzeros over an (A x B) device grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class GridLayout:
    """Nonzeros partitioned over an ``A x B`` device grid.

    Ballard, Knight and Rouse (arXiv 1708.07401) show that the 1-D
    row-block split cannot meet the MTTKRP communication lower bound at
    high device counts: its combine moves O(I_n * R) per device however
    many devices share the work.  The grid split takes the bound's shape:
    rows are cut into ``A`` contiguous row-block shards (the ``"row"``
    mesh axis) and each shard's sorted nonzero stream into ``B``
    contiguous *cells* (the ``"col"`` axis).  Each device then owns an
    O(I_n * R / (A*B)) slice of the factor, the per-iteration combine is
    an all-gather plus a reduce-scatter over the size-``B`` column axis,
    and the combine's wire per device is ``2 (B-1) * sub_rows * R`` =
    O(I_n * R / A) instead of the 1-D O(I_n * R).

    A cell's stream slice is a contiguous run of its shard's grid steps,
    padded with all-dummy steps so that every one of the shard's
    ``n_rb_shard`` row blocks is visited (the kernels' invariant) and
    ``grid_rb`` stays non-decreasing.  A ``B = 1`` grid is therefore
    bitwise the 1-D sharded schedule.

    Attributes:
      slayout:      the ``A``-shard 1-D layout the grid refines.
      grid_a:       row-axis size A (row-block shards).
      grid_b:       column-axis size B (stream cells per shard).
      n_grid_cell:  uniform grid steps per cell (max over cells, padded).
      sub_rows:     rows of one device's owned factor slice,
                    ``ceil(own_rows / B)``.
      own_rows_pad: ``B * sub_rows``: a shard's padded row window as the
                    column collectives see it.
      stack_rows:   rows the factor is padded to before owner slicing
                    (``row_start[-1] + own_rows_pad``).
      cell_nnz:     (A*B,) int64 real nonzeros per cell (balance metric).
      gather:       (A*B, n_grid_cell*block_nnz) int64 into the sorted
                    stream; cell (s, c) at flat index ``s*B + c``.
      valid:        (A*B, n_grid_cell*block_nnz) bool; False for padding.
      local_rows:   (A*B, n_grid_cell*block_nnz) int32 row within block.
      grid_rb:      (A*B, n_grid_cell) int32 shard-local row block per
                    step (non-decreasing, covering [0, n_rb_shard)).
      pad_fraction: overall padding overhead across all cells.
    """

    slayout: ShardedBlockedLayout
    grid_a: int
    grid_b: int
    n_grid_cell: int
    sub_rows: int
    own_rows_pad: int
    stack_rows: int
    cell_nnz: np.ndarray
    gather: np.ndarray
    valid: np.ndarray
    local_rows: np.ndarray
    grid_rb: np.ndarray
    pad_fraction: float
    _device_copies: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def n_shards(self) -> int:
        return self.grid_a * self.grid_b

    @property
    def block_nnz(self) -> int:
        return self.slayout.block_nnz

    @property
    def block_rows(self) -> int:
        return self.slayout.block_rows

    @property
    def n_rows(self) -> int:
        return self.slayout.n_rows

    @property
    def n_rb_shard(self) -> int:
        return self.slayout.n_rb_shard

    def masks(self) -> np.ndarray:
        """(A*B, sub_rows) bool: True on really-owned rows of each
        device's owned slice (cell (s, c) owns rows ``[c*sub_rows,
        (c+1)*sub_rows)`` of shard s's padded row window)."""
        opart = owner_partition(self.slayout)
        k = np.arange(self.sub_rows)[None, :]
        c = np.tile(np.arange(self.grid_b), self.grid_a)[:, None]
        cnt = np.repeat(opart.row_count, self.grid_b)[:, None]
        return (c * self.sub_rows + k) < cnt

    def shard_masks(self) -> np.ndarray:
        """(A*B, own_rows) bool: each cell's copy of its shard's real-row
        mask over the unpadded shard window (what a cell's window is
        masked with before the column reduce-scatter)."""
        return np.repeat(owner_partition(self.slayout).masks(), self.grid_b,
                         axis=0)

    def on(self, device) -> LayoutTensors:
        """The stacked (A*B, ...) index arrays as tensors on ``device``
        (cached)."""
        return _layout_tensors(self, device)

    def masks_on(self, device) -> tuple:
        """(:meth:`masks`, :meth:`shard_masks`) as bool tensors on
        ``device`` (cached, so a captured CUDA graph copies nothing from
        the host)."""
        key = f"masks:{torch.device(device)}"
        m = self._device_copies.get(key)
        if m is None:
            m = (torch.as_tensor(self.masks(), device=device),
                 torch.as_tensor(self.shard_masks(), device=device))
            self._device_copies[key] = m
        return m


def grid_factor_pairs(n_shards: int) -> list:
    """All ``(A, B)`` with ``A * B == n_shards`` (A >= 1, B >= 1)."""
    n = int(n_shards)
    return [(a, n // a) for a in range(1, n + 1) if n % a == 0]


def choose_grid_shape(n_rows: int, block_rows: int, rank: int,
                      n_shards: int, stats: "ModeStats | None" = None,
                      itemsize: int = 4) -> tuple:
    """Wire-minimal ``(A, B)`` grid shape for one mode, from its skew.

    Models the combine's wire per device: the 1-D path (``B = 1``) pays
    the owner reduce-scatter's ``(S-1) * own_rows * R``, an ``A x B``
    grid ``2 (B-1) * ceil(own_rows_A / B) * R`` for the column
    all-gather and reduce-scatter.  A hub mode (one row owning more than
    a quarter of the nonzeros, ``dup_bin <= 1``) cannot be balanced by a
    row split, only the column split shares the hub's work, so skewed
    modes take any wire advantage; near-uniform modes stay 1-D unless
    the grid at least halves the wire (two collectives per inner
    iteration cost latency too).  Modes with fewer row blocks than A
    take shapes that fit; ``(S, 1)`` fits whenever 1-D does.
    """
    s = int(n_shards)
    if s <= 1:
        return (max(s, 1), 1)
    n_rb = max(-(-int(n_rows) // int(block_rows)), 1)
    br = int(block_rows)

    def wire(a: int, b: int) -> float:
        own = -(-n_rb // a) * br
        if b <= 1:
            return float((s - 1) * own * rank * itemsize)
        sub = -(-own // b)
        return float(2 * (b - 1) * sub * rank * itemsize)

    feasible = [(a, b) for a, b in grid_factor_pairs(s) if a <= n_rb]
    if not feasible:
        return (s, 1)
    best = min(feasible, key=lambda ab: (wire(*ab), ab[1]))
    if best[1] == 1:
        return best
    hub = stats is not None and stats.nnz > 0 and stats.dup_bin <= 1
    if not hub and wire(*best) > 0.5 * wire(s, 1):
        return (s, 1)
    return best


def build_grid_layout(layout: BlockedLayout, grid_shape: "Sequence[int]",
                      bounds: "Sequence[int] | None" = None) -> GridLayout:
    """Partition a blocked layout over an ``(A, B)`` device grid.

    Rows split into ``A`` contiguous row-block shards (exactly
    :func:`shard_blocked_layout`, honouring ``bounds``); each shard's
    grid-step stream then splits into ``B`` contiguous cells balanced by
    real nonzeros per step.  Raises ``ValueError`` when a shard has fewer
    grid steps than ``B`` (every cell must own at least one step).
    """
    a, b = (int(x) for x in grid_shape)
    if a < 1 or b < 1:
        raise ValueError(f"grid_shape must be >= (1, 1), got {(a, b)}")
    slayout = shard_blocked_layout(layout, a, bounds=bounds)
    bn = slayout.block_nnz
    n_rb_shard = slayout.n_rb_shard
    n_gs = slayout.n_grid_shard
    if b > n_gs:
        raise ValueError(
            f"grid_b={b} exceeds grid steps per shard ({n_gs}); "
            "use a smaller block_nnz or a narrower grid"
        )

    # each shard's contiguous step -> cell split, balanced by real
    # nonzeros per step
    step_nnz = slayout.valid.reshape(a, n_gs, bn).sum(axis=2)
    cell_cuts = []
    for s in range(a):
        w = step_nnz[s].astype(np.float64)
        if w.sum() <= 0.0:
            w = np.ones(n_gs)
        cell_cuts.append(_split_row_blocks(w, b))

    # a cell visits every one of its shard's n_rb_shard row blocks (dummy
    # steps before and after its own), so every kernel output window is
    # initialized and grid_rb stays non-decreasing
    spans = np.zeros((a, b, 2), np.int64)  # (rb_lo, rb_hi) per cell
    steps = np.zeros((a, b), np.int64)
    for s in range(a):
        for c in range(b):
            c0, c1 = cell_cuts[s][c], cell_cuts[s][c + 1]
            rb_lo = int(slayout.grid_rb[s, c0])
            rb_hi = int(slayout.grid_rb[s, c1 - 1])
            spans[s, c] = (rb_lo, rb_hi)
            steps[s, c] = rb_lo + (c1 - c0) + (n_rb_shard - 1 - rb_hi)
    n_grid_cell = int(steps.max())

    slot = n_grid_cell * bn
    gather = np.zeros((a * b, slot), np.int64)
    valid = np.zeros((a * b, slot), bool)
    local_rows = np.zeros((a * b, slot), np.int32)
    grid_rb = np.zeros((a * b, n_grid_cell), np.int32)
    cell_nnz = np.zeros(a * b, np.int64)
    for s in range(a):
        for c in range(b):
            f = s * b + c
            c0, c1 = cell_cuts[s][c], cell_cuts[s][c + 1]
            rb_lo, rb_hi = (int(x) for x in spans[s, c])
            pre = np.arange(rb_lo, dtype=np.int32)
            real = slayout.grid_rb[s, c0:c1].astype(np.int32)
            post = np.arange(rb_hi + 1, n_rb_shard, dtype=np.int32)
            pad = np.full(
                n_grid_cell - pre.size - real.size - post.size,
                n_rb_shard - 1, np.int32,
            )
            grid_rb[f] = np.concatenate([pre, real, post, pad])
            lo, hi = pre.size * bn, (pre.size + real.size) * bn
            gather[f, lo:hi] = slayout.gather[s, c0 * bn:c1 * bn]
            valid[f, lo:hi] = slayout.valid[s, c0 * bn:c1 * bn]
            local_rows[f, lo:hi] = slayout.local_rows[s, c0 * bn:c1 * bn]
            cell_nnz[f] = int(np.count_nonzero(valid[f]))

    opart = owner_partition(slayout)
    sub_rows = -(-opart.own_rows // b)
    own_rows_pad = b * sub_rows
    stack_rows = int(opart.row_start[-1]) + own_rows_pad
    nnz = int(cell_nnz.sum())
    pad_fraction = 0.0 if nnz == 0 else 1.0 - nnz / max(a * b * slot, 1)

    return GridLayout(
        slayout=slayout,
        grid_a=a,
        grid_b=b,
        n_grid_cell=n_grid_cell,
        sub_rows=sub_rows,
        own_rows_pad=own_rows_pad,
        stack_rows=stack_rows,
        cell_nnz=cell_nnz,
        gather=gather,
        valid=valid,
        local_rows=local_rows,
        grid_rb=grid_rb,
        pad_fraction=float(pad_fraction),
    )


# ---------------------------------------------------------------------------
# Shard-local Π gather: per-shard unique-row index maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPiGather:
    """Per-shard unique-row index maps for the shard-local Π^(n) gather.

    Each shard builds its own Π rows from only the factor rows its
    nonzeros touch:

        fg_m    = A^(m)[touched[m][s]]            # (U_m, R) shard-local
        pi[j,:] = prod_m fg_m[local_idx[m][s, j]] # per expanded slot

    so the per-device Π inputs are O(nnz/S) index entries plus
    O(touched_rows * R) gathered factor rows instead of O(I * R)
    replicated factors.  Arrays are padded to uniform shapes (``U_m`` is
    the max unique-row count over shards for gathered mode ``m``; padding
    rows point at row 0 and padding slots at local index 0, masked by the
    layout's ``valid``).

    Attributes:
      mode:          the excluded (reduce) mode n.
      n_modes:       total tensor modes N.
      n_shards:      shard count S (matches the owning layout).
      modes:         the gathered modes, ascending, ``mode`` excluded.
      touched:       per gathered mode: (S, U_m) int32 global factor rows.
      touched_count: (S, N-1) int32 real unique-row counts per shard.
      local_idx:     per gathered mode: (S, slot) int32 position of each
                     expanded nonzero slot inside its shard's touched list.
      rb_start:      the owning layout's shard assignment; consumers
                     check it before use.
    """

    mode: int
    n_modes: int
    n_shards: int
    modes: tuple
    touched: tuple
    touched_count: np.ndarray
    local_idx: tuple
    rb_start: tuple
    _device_copies: dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def touched_rows_pad(self) -> int:
        """Total padded gathered factor rows per device (sum of U_m)."""
        return int(sum(t.shape[1] for t in self.touched))

    def gather_bytes(self, rank: int, itemsize: int = 4) -> int:
        """Per-device bytes of the gathered factor rows."""
        return self.touched_rows_pad * rank * itemsize

    def replicated_bytes(self, shape: Sequence[int], rank: int,
                         itemsize: int = 4) -> int:
        """Bytes the replicated baseline moves per device: the full factor
        matrix of every gathered mode."""
        return sum(int(shape[m]) for m in self.modes) * rank * itemsize

    def on(self, device) -> tuple:
        """``(touched, local_idx)`` as int64 tensors on ``device`` (cached).

        The ``local_idx`` tensors are column views of one (S, slot, N-1)
        tensor: a strided index takes PyTorch's faster row-gather kernel
        on the card, as ``pi_rows``'s ``indices[:, m]`` does.
        """
        device = torch.device(device)
        key = str(device)
        out = self._device_copies.get(key)
        if out is None:
            idx = torch.as_tensor(np.stack(self.local_idx, axis=-1),
                                  dtype=torch.int64, device=device)
            out = (
                tuple(torch.as_tensor(t, dtype=torch.int64, device=device)
                      for t in self.touched),
                tuple(idx[..., j] for j in range(len(self.modes))),
            )
            self._device_copies[key] = out
        return out


def build_shard_pi_gather(
    slayout: ShardedBlockedLayout, sorted_idx: np.ndarray, mode: int
) -> ShardedPiGather:
    """Build the per-shard unique-row maps for mode ``mode``'s Π gather.

    ``sorted_idx`` is the (nnz, N) coordinate array in the mode's sorted
    order (``ModeView.sorted_idx``), the stream the layout's ``gather``
    indexes into.  Host numpy, once per mode.
    """
    if isinstance(sorted_idx, torch.Tensor):
        sorted_idx = sorted_idx.detach().cpu().numpy()
    sorted_idx = np.asarray(sorted_idx)
    n_modes = int(sorted_idx.shape[1])
    mode = int(mode)
    if not 0 <= mode < n_modes:
        raise ValueError(f"mode {mode} out of range for {n_modes}-mode index")
    s_count = slayout.n_shards
    slot = slayout.gather.shape[1]
    modes = tuple(m for m in range(n_modes) if m != mode)

    uniq_lists: dict = {m: [] for m in modes}
    local_idx = {m: np.zeros((s_count, slot), np.int32) for m in modes}
    touched_count = np.zeros((s_count, len(modes)), np.int32)
    for s in range(s_count):
        v = slayout.valid[s]
        g = slayout.gather[s][v]  # sorted-stream positions of real nonzeros
        for j, m in enumerate(modes):
            uniq, inv = np.unique(sorted_idx[g, m], return_inverse=True)
            uniq_lists[m].append(uniq.astype(np.int32))
            local_idx[m][s, v] = inv.astype(np.int32)
            touched_count[s, j] = uniq.size

    touched = []
    for j, m in enumerate(modes):
        u_pad = max(1, int(touched_count[:, j].max()))
        t = np.zeros((s_count, u_pad), np.int32)
        for s in range(s_count):
            u = uniq_lists[m][s]
            t[s, : u.size] = u
        touched.append(t)

    return ShardedPiGather(
        mode=mode,
        n_modes=n_modes,
        n_shards=s_count,
        modes=modes,
        touched=tuple(touched),
        touched_count=touched_count,
        local_idx=tuple(local_idx[m] for m in modes),
        rb_start=tuple(int(x) for x in slayout.rb_start),
    )
