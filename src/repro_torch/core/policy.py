"""Parallel policy for the Φ kernels (paper Secs. 4.3-4.6).

    strategy    in {scatter, segment, blocked, cuda}
    block_nnz   ~ vector length: nonzeros per grid step
    block_rows  ~ team share: rows of B/Φ per row block
    (grid size  ~ league: derived, = padded_nnz / block_nnz)

``heuristic_policy`` gives the same outputs as the JAX package's for
``platform="cpu"`` and ``"tpu"``.  It has no branch sized for the H100
yet; any other platform takes the TPU sizing, and the solver on the card
uses :func:`default_policy` blocking or an explicit :class:`PhiPolicy`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "DENSE_FILL_BIN_MAX",
    "DENSE_MAX_ELEMS",
    "PhiPolicy",
    "default_policy",
    "heuristic_policy",
    "vmem_footprint_bytes",
]

# Near-dense cut for the matrix-free tier: fill bins 0 and 1 (> 2^-2 fill).
DENSE_FILL_BIN_MAX = 1
# Largest densified mode (cells) the dense tier accepts.
DENSE_MAX_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class PhiPolicy:
    strategy: str = "segment"
    block_nnz: int = 256
    block_rows: int = 256
    gather_mode: str = "prefetch"  # 'prefetch' (stream rows) | 'vmem' (resident)

    def label(self) -> str:
        return f"{self.strategy}:{self.block_nnz}:{self.block_rows}:{self.gather_mode}"


def default_policy(rank: int) -> PhiPolicy:
    """The 'SparTen default' analog used as the baseline policy."""
    return PhiPolicy(strategy="segment", block_nnz=256, block_rows=256)


def vmem_footprint_bytes(p: PhiPolicy, rank: int, itemsize: int = 4) -> int:
    """Working set of one grid step of the TPU blocked kernel.

    B window + Φ accumulator + Π block + values + one-hot block, with the
    rank padded to 128 lanes (the TPU sizing the heuristic reproduces).
    """
    r = max(rank, 128)  # lane padding
    return itemsize * (
        2 * p.block_rows * r  # B window + Phi accumulator
        + p.block_nnz * r  # Pi block
        + p.block_nnz  # values
        + p.block_nnz * p.block_rows  # one-hot
    )


def heuristic_policy(
    nnz: int,
    n_rows: int,
    rank: int,
    vmem_budget: int = 8 * 2**20,
    row_hist: np.ndarray | None = None,
    platform: str = "cpu",
    stats: "object | None" = None,
) -> PhiPolicy:
    """Pick (strategy, block_nnz, block_rows) from tensor stats + platform.

    * duplication d = nnz / n_rows (mean segment run length); block_nnz
      covers a few average rows per step;
    * block_rows covers the p95 segment run (``stats.p95_run`` when a
      :class:`repro_torch.core.layout.ModeStats` is given, else
      ``row_hist``, else d) so one grid step rarely spans row blocks;
    * a near-dense mode (fill bin <= 1, cells <= 2^22) goes to the dense
      tier.

    ``platform="cpu"`` keeps the sorted segmented reduce with cache-model
    block sizes; every other platform takes the TPU's blocked sizing.
    """
    if stats is not None and getattr(stats, "fill_bin", -1) >= 0:
        fill = float(getattr(stats, "fill_frac", 0.0))
        if stats.fill_bin <= DENSE_FILL_BIN_MAX and fill > 0.0:
            cells = nnz / fill
            if cells <= DENSE_MAX_ELEMS:
                return PhiPolicy(strategy="dense", block_nnz=8)
    d = max(1.0, nnz / max(1, n_rows))
    if stats is not None and getattr(stats, "nnz", 0) > 0:
        p95 = max(float(stats.p95_run), 1.0)
    elif row_hist is not None and row_hist.size:
        p95 = float(np.percentile(row_hist, 95))
    else:
        p95 = d
    if platform == "cpu":
        bn = int(2 ** np.clip(np.round(np.log2(2 * d)), 6, 10))
        br = int(2 ** np.clip(np.round(np.log2(max(bn / max(p95, 1.0), 8))), 3, 8))
        p = PhiPolicy(strategy="segment", block_nnz=bn, block_rows=br)
        l2_budget = 1 << 20
        while vmem_footprint_bytes(p, rank) > l2_budget and p.block_nnz > 64:
            p = dataclasses.replace(p, block_nnz=p.block_nnz // 2)
        while vmem_footprint_bytes(p, rank) > l2_budget and p.block_rows > 8:
            p = dataclasses.replace(p, block_rows=p.block_rows // 2)
        return p
    bn = int(2 ** np.clip(np.round(np.log2(4 * d)), 6, 11))
    br = int(2 ** np.clip(np.round(np.log2(max(bn / max(p95, 1.0), 8))), 3, 10))
    p = PhiPolicy(strategy="blocked", block_nnz=bn, block_rows=br)
    while vmem_footprint_bytes(p, rank) > vmem_budget and p.block_nnz > 64:
        p = dataclasses.replace(p, block_nnz=p.block_nnz // 2)
    while vmem_footprint_bytes(p, rank) > vmem_budget and p.block_rows > 8:
        p = dataclasses.replace(p, block_rows=p.block_rows // 2)
    return p
