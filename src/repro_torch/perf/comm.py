"""The communication model of the sharded and grid tiers, and its evidence.

The counterpart of the JAX package's ``repro/perf/hlo.py``.  Its analytic
half is carried over with the same names, signatures, defaults and
arithmetic: the ring wire factors of each collective kind, the bounds
the sharded Φ combines, the grid combine and the shard-local Π gather
are held to, the Ballard/Knight/Rouse MTTKRP lower bound, and the dense
tier's operand and FLOP counts.  Ring wire per participant, for a group
of N ranks and ``size`` the bytes of the per-rank result:

    all-reduce         2 (N-1)/N x size     (reduce-scatter + all-gather)
    all-gather           (N-1)/N x size     (size = gathered output)
    reduce-scatter       (N-1)   x size     (input ~= output x N)
    all-to-all           (N-1)/N x size
    collective-permute   1       x size

The reference reads its evidence from XLA's partitioned HLO text.  The
port compiles no XLA program, so its two readers take the port's own:

  * :func:`record_collectives` logs each collective the tiers issue
    through ``repro_torch.core.distributed``'s three wrappers (kind,
    group size, per-rank result as an HLO type string, the group's tag),
    and :func:`collective_stats` sums such a log as the reference sums
    HLO lines;
  * :func:`entry_parameter_bytes` gives the per-rank bytes of the
    tensors a call receives, as the reference gives those of a compiled
    program's ENTRY parameters.

There is no compiler between the port and its collectives, so a recorded
wire equals the model exactly where the reference allows XLA's rewrites
some slack.  This module imports ``torch`` only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict

import torch

__all__ = [
    "Collective",
    "CollectiveStats",
    "allreduce_wire_bytes",
    "collective_stats",
    "dense_input_bytes",
    "dense_mttkrp_flops",
    "dense_pad_dims",
    "entry_parameter_bytes",
    "grid_combine_wire_bound",
    "mttkrp_comm_lower_bound",
    "phi_combine_wire_bound",
    "phi_reduce_scatter_wire_bound",
    "pi_gather_wire_bound",
    "pi_replicated_gather_bytes",
    "record_collectives",
    "reduce_scatter_wire_bytes",
    "shape_bytes",
    "type_string",
]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1, "f8e4m3b11fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 0.5, "u4": 0.5, "pred": 1, "c64": 8, "c128": 16,
}

# torch dtypes under their HLO names (the keys of _DTYPE_BYTES)
_HLO_DTYPE = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")


def shape_bytes(type_str: str) -> float:
    """Bytes of an HLO result type (handles tuples)."""
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def type_string(t: torch.Tensor) -> str:
    """A tensor's dtype and shape as an HLO type, ``f32[4096,16]``, which
    :func:`shape_bytes` reads back to the tensor's bytes."""
    return f"{_HLO_DTYPE[t.dtype]}[{','.join(str(int(d)) for d in t.shape)}]"


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1 and kind != "collective-permute":
        return 0.0  # single-participant collective moves nothing
    ring = (n - 1) / n
    return {
        "all-reduce": 2 * ring,
        "all-gather": ring,
        "reduce-scatter": ring * n,  # input bytes ~= output x N
        "all-to-all": ring,
        "collective-permute": 1.0,
    }[kind]


def allreduce_wire_bytes(buffer_bytes: float, n_participants: int) -> float:
    """Ring all-reduce per-chip wire traffic for one ``buffer_bytes`` psum."""
    n = n_participants
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * buffer_bytes


def phi_combine_wire_bound(
    n_rows: int,
    rank: int,
    n_shards: int,
    block_rows: int = 256,
    itemsize: int = 4,
) -> float:
    """Analytic O(I_n * R) upper bound on the sharded-Φ psum combine.

    The combine is one all-reduce of the (buf_rows, R) partial-Φ buffer.
    ``buf_rows`` is I_n padded to the row-block grid plus at most one
    (padded) shard window of slack, and a shard window never exceeds the
    global window, so buf_rows <= 2 * n_rows_pad and the wire is bounded
    by a ring all-reduce of ``2 * n_rows_pad * R`` elements: independent
    of nnz and of the shard count (up to the ring factor), the bound
    Ballard et al.'s MTTKRP communication analysis puts on the
    factor-matrix combine.  Holds for any shard split.
    """
    n_rows_pad = -(-max(n_rows, block_rows) // block_rows) * block_rows
    return allreduce_wire_bytes(2 * n_rows_pad * rank * itemsize, n_shards)


def reduce_scatter_wire_bytes(output_bytes: float, n_participants: int) -> float:
    """Ring reduce-scatter per-chip wire traffic for one scattered combine
    whose per-device *output* is ``output_bytes`` (input ~= output x N)."""
    n = n_participants
    if n <= 1:
        return 0.0
    return (n - 1) * output_bytes


def phi_reduce_scatter_wire_bound(
    n_rows: int,
    rank: int,
    n_shards: int,
    block_rows: int = 256,
    itemsize: int = 4,
) -> float:
    """Analytic bound on the reduce-scatter Φ combine's per-device wire.

    The owner-partitioned combine scatters the (S * own_rows, R)
    owner-slot operand; each device's output is its owned
    ``own_rows * R`` slice.  For a balanced row-block split every owner
    window stays within 2x the mean (``own_rows <= 2 * n_rows_pad / S``,
    the factor-2 slack of :func:`phi_combine_wire_bound`), so the ring
    wire is bounded by

        (S - 1) * (2 * n_rows_pad / S) * R * itemsize
          = 2 (S-1)/S * n_rows_pad * R * itemsize

    exactly half the psum bound.  Skewed (hub) splits can exceed the
    factor-2 window slack, so only balanced splits are held to it.
    """
    if n_shards <= 1:
        return 0.0
    n_rows_pad = -(-max(n_rows, block_rows) // block_rows) * block_rows
    own_rows_bound = 2.0 * n_rows_pad / n_shards
    return reduce_scatter_wire_bytes(
        own_rows_bound * rank * itemsize, n_shards
    )


def mttkrp_comm_lower_bound(
    n_rows: int,
    rank: int,
    n_devices: int,
    itemsize: int = 4,
) -> float:
    """Ballard/Knight/Rouse per-device MTTKRP communication lower bound.

    arXiv 1708.07401 (Thm. 4.1 family): any P-device MTTKRP whose factor
    data is evenly spread must move Omega(I_n * R / P) words of mode-n
    factor per device.  The 1-D row-block combine pays O(I_n * R) per
    device whatever P, so it cannot meet this bound at high device
    counts; the grid combine's per-device wire
    (:func:`grid_combine_wire_bound`) is O(I_n * R / A), the bound's
    shape.
    """
    if n_devices <= 1:
        return 0.0
    return float(n_rows) * rank * itemsize / n_devices


def grid_combine_wire_bound(
    sub_rows: int,
    rank: int,
    grid_b: int,
    itemsize: int = 4,
) -> float:
    """Per-device wire of one grid-combine inner iteration.

    The ``A x B`` grid's only collectives in an inner iteration are the
    column-axis pair: an all-gather of the (B * sub_rows, R) B window
    (ring: ``(B-1) * sub_rows * R``) and a reduce-scatter whose
    per-device output is the owned (sub_rows, R) tile (ring: ``(B-1) *
    sub_rows * R``), so

        wire = 2 (B-1) * sub_rows * R * itemsize

    with ``sub_rows ~= I_n / (A * B)``: O(I_n * R / A) in all.  ``B=1``
    grids have no column collective at all.
    """
    if grid_b <= 1:
        return 0.0
    return float(2 * (grid_b - 1) * sub_rows * rank * itemsize)


def pi_gather_wire_bound(
    slot_per_shard: int,
    touched_rows_pad: int,
    rank: int,
    n_modes: int,
    itemsize: int = 4,
    idx_itemsize: int = 4,
) -> float:
    """Analytic per-device byte bound on the shard-local Π gather inputs.

    With the shard-local Π gather
    (:class:`repro_torch.core.layout.ShardedPiGather`) each device reads,
    per mode update:

      * its padded nonzero slots: values (``itemsize``), validity (1 byte)
        and one local-index map per gathered mode (``idx_itemsize`` each):
        O(nnz / S);
      * the factor rows its nonzeros touch: ``touched_rows_pad`` rows of
        R values across the N-1 gathered modes: O(touched_rows * R);

    in place of the replicated path's O(sum_m I_m * R) factor bytes per
    device (:func:`pi_replicated_gather_bytes`).  The port's index maps
    are int64 (``ShardedPiGather.on``), so it evaluates the bound at
    ``idx_itemsize=8``.
    """
    per_slot = (n_modes - 1) * idx_itemsize + 1 + itemsize
    return float(slot_per_shard * per_slot
                 + touched_rows_pad * rank * itemsize)


def pi_replicated_gather_bytes(
    shape, mode: int, rank: int, itemsize: int = 4
) -> float:
    """Factor bytes the replicated Π path holds on *every* device: the
    full (I_m, R) matrix of each gathered mode, the O(I * R) term the
    shard-local gather removes."""
    return float(
        sum(int(s) for m, s in enumerate(shape) if m != mode)
        * rank * itemsize
    )


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // int(m)) * int(m)


def dense_pad_dims(
    k: int, i: int, j: int, rank: int,
    itemsize: int = 4, block_k: int | None = None,
) -> tuple:
    """Tile-padded dims of the TPU dense kernels' operands.

    These describe the JAX package's Pallas kernels
    (``repro.kernels.dense.ops._pad_dense``): I to the sublane multiple
    (8 for 4-byte elements, 16 for bf16), J and R to the 128-lane width,
    K to a whole number of ``block_k`` slices (``block_k`` defaults to
    the sublane).  Returns ``(k_pad, i_pad, j_pad, r_pad)``.  The port's
    dense kernels (``csrc/dense.cu``) pad nothing: their operands are the
    raw dims, which :func:`dense_input_bytes` counts with
    ``padded=False``.
    """
    sub = 16 if itemsize == 2 else 8
    if block_k is None:
        block_k = sub
    return (
        _round_up(max(k, 1), block_k),
        _round_up(i, sub),
        _round_up(j, 128),
        _round_up(rank, 128),
    )


def dense_mttkrp_flops(k: int, i: int, j: int, rank: int) -> float:
    """Useful FLOPs of one dense matrix-free MTTKRP / Φ contraction.

    Per K-slice one ``(I, J) @ (J, R)`` product (``2 I J R``) plus the
    rank-1 ``a[k]`` scale-and-accumulate (``2 I R``); the Φ/MU epilogues
    add only O(I R).  On raw dims this is the algorithmic count, on
    :func:`dense_pad_dims` what the TPU's padded program executes.
    """
    return float(2.0 * k * i * rank * (j + 1.0))


def dense_input_bytes(
    k: int, i: int, j: int, rank: int,
    itemsize: int = 4,
    with_b: bool = False,
    padded: bool = False,
    block_k: int | None = None,
) -> float:
    """Bytes of the dense-tier kernel operands.

    ``padded=False`` (the default) counts the raw ``x (K, I, J)``, ``c (J,
    R)`` and ``a (K, R)``, plus ``b (I, R)`` for the Φ and fused MU
    kernels (``with_b=True``): exactly the operands the port's dense
    wrappers (``repro_torch.kernels.dense.ops``) hand their kernels, as
    they are the ENTRY parameters of the reference's jitted entry points.

    ``padded=True`` applies :func:`dense_pad_dims` first: the bytes the
    TPU kernels' padded tiles stream.  The port's dense kernels pad
    nothing, so for the port ``padded=False`` is the operand count.
    """
    if padded:
        k, i, j, rank = dense_pad_dims(k, i, j, rank, itemsize, block_k)
    total = k * i * j + j * rank + k * rank
    if with_b:
        total += i * rank
    return float(total * itemsize)


def entry_parameter_bytes(tensors) -> list:
    """Per-rank bytes of the tensors a call receives, in order.

    A DTensor counts its local shard, a plain tensor all of itself: the
    bytes each rank holds for every operand, the measurement side of
    :func:`pi_gather_wire_bound` and :func:`dense_input_bytes` (the
    reference reads the same from a compiled program's ENTRY
    parameters).
    """
    from torch.distributed.tensor import DTensor

    out = []
    for t in tensors:
        local = t.to_local() if isinstance(t, DTensor) else t
        out.append(float(local.numel() * local.element_size()))
    return out


# ---------------------------------------------------------------------------
# The port's collectives, recorded
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a tier issued: its kind under the HLO name, the
    size of its group, its per-rank result as an HLO type string (an
    all-gather's gathered output, a reduce-scatter's scattered output, an
    all-reduce's buffer) and the tag of the group (``"data"``, ``"col"``,
    ``"row"``, ``"model"`` or ``"world"``)."""

    kind: str
    group_size: int
    type: str
    tag: str

    @property
    def bytes(self) -> float:
        return shape_bytes(self.type)

    @property
    def itemsize(self) -> float:
        """Bytes of one element of the result."""
        return _DTYPE_BYTES[self.type.split("[", 1)[0]]


@contextlib.contextmanager
def record_collectives():
    """Log every collective ``repro_torch.core.distributed`` issues in the
    block; yields the list the :class:`Collective` entries are appended
    to, in issue order.

    An entry is added after its collective returns, so a collective that
    raises is not logged, and its error propagates.  Outside the block
    the wrappers only test that no recorder is set.  The innermost block
    records; an outer one resumes when it ends.
    """
    import torch.distributed as dist

    from ..core import distributed as D

    log: list = []

    def record(kind: str, result: torch.Tensor, group, tag: str) -> None:
        log.append(Collective(kind, dist.get_world_size(group),
                              type_string(result), tag))

    outer = D._recorder
    D._recorder = record
    try:
        yield log
    finally:
        D._recorder = outer


@dataclasses.dataclass
class CollectiveStats:
    by_kind_bytes: dict  # raw result bytes per kind
    by_kind_count: dict
    by_kind_wire: dict  # ring-adjusted wire bytes per kind
    wire_bytes: float  # total per-chip wire traffic

    @property
    def total_bytes(self) -> float:
        return float(sum(self.by_kind_bytes.values()))


def collective_stats(log, n_participants: int = 0) -> CollectiveStats:
    """Sum the collective bytes of a :func:`record_collectives` log, with
    each entry's ring wire factor from its own group size.

    ``n_participants``: the ring size for an entry whose group size is 0
    (0 disables the wire adjustment for it), as the reference's fallback
    for an HLO line without ``replica_groups``.
    """
    by_bytes: dict = defaultdict(float)
    by_count: dict = defaultdict(int)
    by_wire: dict = defaultdict(float)
    for c in log:
        b = shape_bytes(c.type)
        n = c.group_size or n_participants
        by_bytes[c.kind] += b
        by_count[c.kind] += 1
        by_wire[c.kind] += b * (_wire_factor(c.kind, n) if n else 1.0)
    return CollectiveStats(
        by_kind_bytes=dict(by_bytes),
        by_kind_count=dict(by_count),
        by_kind_wire=dict(by_wire),
        wire_bytes=float(sum(by_wire.values())),
    )
