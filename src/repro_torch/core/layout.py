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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "BlockedLayout",
    "LayoutTensors",
    "ModeStats",
    "build_blocked_layout",
    "fill_stats",
    "mode_run_stats",
    "pad_rows",
    "round_up",
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
    """Device copies of a layout's index arrays (what the kernels read)."""

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
        device = torch.device(device)
        key = str(device)
        lt = self._device_copies.get(key)
        if lt is None:
            lt = LayoutTensors(
                gather=torch.as_tensor(self.gather, dtype=torch.int64,
                                       device=device),
                valid=torch.as_tensor(self.valid, device=device),
                local_rows=torch.as_tensor(self.local_rows,
                                           dtype=torch.int32, device=device),
                grid_rb=torch.as_tensor(self.grid_rb, dtype=torch.int32,
                                        device=device),
            )
            self._device_copies[key] = lt
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
