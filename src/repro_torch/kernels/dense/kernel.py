"""ctypes launchers for the dense kernel (``kernels/csrc/dense.cu``) and its
launch shape.

Built from the checkout's source at first use and loaded once per
process.  The launchers take device tensors that the wrappers in
``ops.py`` have already checked, enqueue on PyTorch's current stream
without synchronising, and raise if the C launcher reports a CUDA error.

The launch shape is chosen here, on the host, and passed to the kernel:
a CTA takes ``ti`` rows of ``x`` and a contiguous range of its K slices
(``n_ks`` ranges), walking the J columns ``jc`` at a time.  Each CTA
writes its (ti, R) partial into a work buffer, and the partials of each
row tile are summed in a fixed two-level tree, the last CTA of each level
doing the sum (``workspace`` keeps the buffer and the tickets).
:func:`smem_bytes` mirrors ``dense.cu``'s ``dense_shape``; an on-card
test holds the two equal.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from .._build import DTYPE_CODE, F as _F, I as _I, P as _P, check_launch, stream_of

__all__ = ["DenseShape", "OPS", "launch_mttkrp", "launch_phi", "launch_phi_mu",
           "launch_shape", "library_smem_bytes", "load_library", "smem_bytes",
           "workspace"]

_SIGNATURES = {
    "dense_mttkrp_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    "dense_phi_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _F, _P],
    "dense_phi_mu_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F, _P],
    "dense_smem_bytes": [_I, _I, _I, _I, _I],
}

#: the ``op`` code of each kernel name (``dense.cu``'s ``Op``)
OPS = {"dense_mttkrp": 0, "dense_phi": 1, "dense_phi_mu": 2}
_THREADS = 256  # threads per CTA
_STAGES = 3  # x tiles in the ring
# CTAs a call aims for: two resident per SM on the H100's 132 SMs, one wave
_TARGET_CTAS = 2 * 132
# shared bytes per CTA at which two CTAs fit an SM; jc narrows to stay under
_SMEM_BUDGET = 110 * 1024
_GROUP = 8  # k-ranges per group of the partials' tree (dense.cu's kGroup)


def _odd4(n: int) -> int:
    """n rounded up to a multiple of 4 whose quotient by 4 is odd."""
    m = (n + 3) // 4
    return 4 * (m if m % 2 else m + 1)


def smem_bytes(rank: int, ti: int, jc: int, dtype: torch.dtype = torch.float32,
               op: str = "dense_phi") -> int:
    """Shared memory per CTA of the dense kernel at tile ``ti x jc``: the
    f32 B tile and round(c∘a_k) tile (Φ only), the f32 c chunk, the f32
    weight tile and three x tiles; at the end the split partials reuse all
    but the B tile.  Rows are padded to an odd number of 16-byte units.
    Does not depend on J beyond ``jc``."""
    isz = 2 if dtype == torch.bfloat16 else 4
    phi = op != "dense_mttkrp"
    rp = (rank + 3) // 4 * 4
    rs = _odd4(rank)
    xb = (jc * isz + 15) // 16
    xs = 16 * (xb if xb % 2 else xb + 1) // isz
    nb = (ti // 4) * (rp // 4)
    splits = 1 if nb >= _THREADS else _THREADS // nb
    bt = 4 * ti * rs if phi else 0
    ca = 4 * jc * rs if phi else 0
    loop = ca + 4 * jc * rs + 4 * ti * _odd4(jc) + _STAGES * ti * xs * isz
    return bt + max(loop, 4 * splits * ti * rp)


@dataclasses.dataclass(frozen=True)
class DenseShape:
    """One call's launch shape: ``n_itiles * n_ks`` CTAs of ``ti`` rows
    and ``ceil(K/n_ks)`` or ``floor(K/n_ks)`` slices, ``jc`` columns at a
    time, ``smem`` shared bytes each."""

    ti: int
    jc: int
    n_ks: int
    n_itiles: int
    rank: int
    smem: int

    @property
    def part_numel(self) -> int:
        """f32 entries of the partials buffer: (n_ks, n_itiles*ti, R)."""
        return self.n_ks * self.n_itiles * self.ti * self.rank

    @property
    def n_tickets(self) -> int:
        """int32 tickets: per row tile, one for the last level of the
        partials' tree and one per group of ``_GROUP`` k-ranges."""
        return self.n_itiles * (-(-self.n_ks // _GROUP) + 1)

    def k_range(self, ks: int, k: int) -> range:
        """The slices of K that k-range ``ks`` covers (as the kernel cuts
        them)."""
        return range(ks * k // self.n_ks, (ks + 1) * k // self.n_ks)


@functools.lru_cache(maxsize=256)
def launch_shape(k: int, i: int, j: int, rank: int,
                 dtype: torch.dtype = torch.float32,
                 op: str = "dense_phi") -> DenseShape:
    """The launch shape for x (K, I, J) at ``rank``: ti the widest of
    32/16/8/4 rows (at most I rounded up to 4) whose 4 x 4 output tiles of
    phase B fit one per thread; jc the columns that give phase A 256 such
    tiles (at most J rounded up to 8), narrowed by 8 until the footprint
    fits ``_SMEM_BUDGET`` (at least 8); n_ks the fewest equal k-ranges
    that bring the CTA count to about ``_TARGET_CTAS``."""
    rp = (rank + 3) // 4 * 4
    ti = next((t for t in (32, 16, 8) if (t // 4) * (rp // 4) <= _THREADS), 4)
    ti = min(ti, (i + 3) // 4 * 4)
    jc = min(4096 // ti, (j + 7) // 8 * 8)
    while jc > 8 and smem_bytes(rank, ti, jc, dtype, op) > _SMEM_BUDGET:
        jc -= 8
    n_itiles = -(-i // ti)
    per = -(-k // -(-_TARGET_CTAS // n_itiles))  # slices per k-range
    n_ks = -(-k // per)
    return DenseShape(ti=ti, jc=jc, n_ks=n_ks, n_itiles=n_itiles, rank=rank,
                      smem=smem_bytes(rank, ti, jc, dtype, op))


_WORK: dict = {}  # (device, stream, partials, tickets) -> (part, tickets)


def workspace(shape: DenseShape, device) -> tuple:
    """(partials, tickets) for a call on ``device``'s current stream, kept
    per stream and size: the partials' contents do not matter, and the
    tickets, zeroed when the buffer is made, are left zero by every
    launch (the last CTA of each level of the tree resets its ticket), so
    the calls on one stream, which run in turn, share them."""
    dev = torch.device(device)
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else 0)
    key = (dev, stream, shape.part_numel, shape.n_tickets)
    if key not in _WORK:
        _WORK[key] = (
            torch.empty(shape.part_numel, dtype=torch.float32, device=dev),
            torch.zeros(shape.n_tickets, dtype=torch.int32, device=dev))
    return _WORK[key]


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the dense kernel's shared library."""
    return _build.load_library("dense", _SIGNATURES)


def library_smem_bytes(rank: int, ti: int, jc: int,
                       dtype: torch.dtype = torch.float32,
                       op: str = "dense_phi") -> int:
    """The compiled kernel's own count of :func:`smem_bytes`."""
    return int(load_library().dense_smem_bytes(DTYPE_CODE[dtype], OPS[op],
                                               rank, ti, jc))


def _args(x, c, shape: DenseShape) -> tuple:
    k, i, j = x.shape
    return (int(k), int(i), int(j), int(c.shape[1]), shape.ti, shape.jc,
            shape.n_ks)


def launch_mttkrp(x, c, a, out, part, tickets, shape: DenseShape) -> None:
    """Enqueue dense MTTKRP into the f32 (I, R) ``out``."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_mttkrp_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            *_args(x, c, shape), stream_of(x))
    check_launch("dense_mttkrp", err)


def launch_phi(x, c, a, b, phi, part, tickets, shape: DenseShape, *,
               eps: float) -> None:
    """Enqueue dense Φ into the f32 (I, R) ``phi``."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_phi_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            b.data_ptr(), phi.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            *_args(x, c, shape), float(eps), stream_of(x))
    check_launch("dense_phi", err)


def launch_phi_mu(x, c, a, b, mu, viol, part, tickets, shape: DenseShape, *,
                  eps: float) -> None:
    """Enqueue the fused dense Φ -> (B*Φ, KKT) step, one kernel; ``viol``
    is a zeroed f32."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.dense_phi_mu_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), c.data_ptr(), a.data_ptr(),
            b.data_ptr(), mu.data_ptr(), viol.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), *_args(x, c, shape), float(eps),
            stream_of(x))
    check_launch("dense_phi_mu", err)
