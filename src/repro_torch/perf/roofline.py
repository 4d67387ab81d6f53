"""Roofline model (paper Sec. 3.2, Eqs. 1-8) and the 3-term roofline.

Two uses:
  1. Paper-faithful: operational intensity of the Φ kernel (Eqs. 3-8)
     against a hardware balance line (Figs. 3-4), for the paper's two
     systems and for the H100 the port runs on.
  2. Per cell: from global flops, bytes and per-chip wire bytes,
         compute term    = flops     / (chips * peak_FLOPs)
         memory term     = bytes     / (chips * HBM_bw)
         collective term = coll_bytes / link_bw
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..core.phi import phi_flops_words
from ..kernels._checks import SMEM_LIMIT

__all__ = [
    "HARDWARE",
    "HardwareSpec",
    "PAPER_STATED_INTENSITY",
    "RooflineTerms",
    "attainable_gflops",
    "detect_hardware_spec",
    "operational_intensity_phi",
    "roofline_terms",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One device's roofline rates.

    ``op_overhead_s``, ``serial_instr_s`` and ``scatter_elem_s`` are the
    JAX package's small-problem overhead coefficients (seconds per kernel
    dispatch, per serial loop step, per scattered element), which its
    autotuner adds to the roofline terms.  They keep the JAX package's
    slots, but the port's autotuner scores from its own analytic counts
    and does not model them, and nothing has measured them on the card:
    so they must stay 0.0, and a non-zero value raises rather than being
    dropped.
    """

    name: str
    peak_flops: float  # FLOP/s per chip (f32 outside the tensor cores on the H100)
    hbm_bw: float  # bytes/s per chip
    link_bw: float = 0.0  # bytes/s per link, each way (0 = single device)
    vmem_bytes: int = 0  # on-chip memory one block may use (shared memory)
    op_overhead_s: float = 0.0
    serial_instr_s: float = 0.0
    scatter_elem_s: float = 0.0

    def __post_init__(self):
        for f in ("op_overhead_s", "serial_instr_s", "scatter_elem_s"):
            if getattr(self, f):
                raise ValueError(
                    f"HardwareSpec.{f}={getattr(self, f)!r}: the port's "
                    f"autotuner does not model small-problem overheads; "
                    f"leave it 0.0")

    @property
    def balance(self) -> float:
        """FLOP/byte at the roofline knee."""
        return self.peak_flops / self.hbm_bw


HARDWARE = {
    # The paper's two systems (Sec. 3.2), for reproducing Figs. 3-4:
    "e5_2690v4_dual": HardwareSpec(
        "dual Intel E5-2690v4", peak_flops=1164.8e9, hbm_bw=153.6e9
    ),
    "k80": HardwareSpec("NVIDIA Tesla K80", peak_flops=2910e9, hbm_bw=480e9),
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 3.35 TB/s HBM3,
    # 67 TFLOP/s f32 outside the tensor cores; a block may use 227 KB of
    # shared memory (Hopper tuning guide).  The rates assume the full 700 W
    # power limit.
    "h100_sxm": HardwareSpec(
        "NVIDIA H100 SXM5", peak_flops=67e12, hbm_bw=3.35e12,
        vmem_bytes=SMEM_LIMIT,
    ),
    # The same part for the LM dry run (launch/dryrun.py): the datasheet's
    # dense bf16 tensor-core peak, 989.4 TFLOP/s (as chip_smoke.py's
    # BF16_TENSOR_FLOPS), and NVLink 4 at 900 GB/s per GPU in both
    # directions together, 450 GB/s each way (NVIDIA H100 Tensor Core GPU
    # datasheet, SXM5 column; the NVLink Switch System joins up to 256
    # such GPUs at that rate).  Rates at the full 700 W power limit.
    "h100_sxm_bf16": HardwareSpec(
        "NVIDIA H100 SXM5 (bf16 tensor cores)", peak_flops=989.4e12,
        hbm_bw=3.35e12, link_bw=450e9, vmem_bytes=SMEM_LIMIT,
    ),
}


def attainable_gflops(intensity: float, hw: HardwareSpec) -> float:
    """P = min(pi, beta * I)   (paper Eq. 2), in GFLOP/s."""
    return min(hw.peak_flops, hw.hbm_bw * intensity) / 1e9


def _spec_for_card(name: str) -> HardwareSpec:
    # The SXM5 part only: the PCIe and NVL parts have other rates.
    if "H100" in name and "PCIe" not in name and "NVL" not in name:
        return HARDWARE["h100_sxm"]
    raise ValueError(
        f"no HardwareSpec for the CUDA card {name!r}; set "
        f"$REPRO_HARDWARE_SPEC to one of {sorted(HARDWARE)} or add its "
        f"published rates to HARDWARE"
    )


def detect_hardware_spec(platform: str | None = None) -> HardwareSpec:
    """HardwareSpec of the card the port runs on.

    Resolution order: ``$REPRO_HARDWARE_SPEC`` (a HARDWARE key), then
    ``platform`` (a HARDWARE key, or ``"cuda"``/``"gpu"`` for the current
    card), then ``torch.cuda.get_device_name()``.  An H100 SXM maps to
    ``h100_sxm``; any other card, or no card, raises rather than
    returning another chip's rates.
    """
    override = os.environ.get("REPRO_HARDWARE_SPEC")
    if override and override in HARDWARE:
        return HARDWARE[override]
    if platform in HARDWARE:
        return HARDWARE[platform]
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(
            f"no HardwareSpec for platform {platform!r}; pass one of "
            f"{sorted(HARDWARE)}, 'cuda' or 'gpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "detect_hardware_spec: no CUDA device; set $REPRO_HARDWARE_SPEC "
            f"or pass one of {sorted(HARDWARE)}"
        )
    return _spec_for_card(torch.cuda.get_device_name())


# The intensities the paper *states* (Eq. 5 / Eq. 8, FLOP/byte).  Note:
# evaluating the paper's own Eqs. 3-4 / 6-7 literally gives W/Q ~ 0.80 / 0.67
# FLOP/word (= 0.10 / 0.084 FLOP/byte with the paper's 8-byte words) — the
# stated 0.125 / 0.27 don't follow from the formulas, but they are what the
# paper's headline bounds derive from (480 GB/s x 0.125 = 60 GFLOP/s K80;
# 153.6 GB/s x 0.27 = 41.5 GFLOP/s Xeon).  We report both.
PAPER_STATED_INTENSITY = {"gpu": 0.125, "cpu": 0.27}  # FLOP/byte


def operational_intensity_phi(
    rank: int,
    variant: str = "gpu",
    v: int = 32,
    word_bytes: int = 8,
    nnz: int = 10**6,
) -> float:
    """Operational intensity of Φ^(n) from the paper's Eqs. 3-4 / 6-7,
    evaluated literally, in FLOP/byte (paper words are 8-byte doubles;
    ``word_bytes=4`` for f32).  ``nnz`` cancels: the intensity is
    nnz-invariant."""
    w, q = phi_flops_words(nnz, rank, variant=variant, v=v)
    return (w / q) / word_bytes


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one cell."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # global (all chips)
    hlo_bytes: float
    collective_bytes: float
    model_flops: float  # useful flops of the algorithm; 0 if n/a
    n_chips: int
    # Peak FLOP/s of the spec these terms were built from (the H100's by
    # default); roofline_terms() always sets it from ``hw``.
    peak_flops: float = HARDWARE["h100_sxm"].peak_flops

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """model_flops / flops: catches redundant work."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-flops utilization implied by the three
        terms, against the peak of the spec that built them."""
        if not self.model_flops or not self.bound_s or not self.peak_flops:
            return 0.0
        return self.model_flops / (self.bound_s * self.n_chips) / self.peak_flops


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    hw: HardwareSpec = HARDWARE["h100_sxm"],
    model_flops: float = 0.0,
) -> RooflineTerms:
    """Build the 3-term roofline.  ``hlo_flops``/``hlo_bytes`` are GLOBAL
    (sum over chips); ``collective_bytes`` is the per-chip wire traffic.
    The names are the JAX package's, which took them from compiled HLO;
    the port passes analytic counts."""
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * hw.peak_flops),
        memory_s=hlo_bytes / (n_chips * hw.hbm_bw),
        collective_s=(collective_bytes / hw.link_bw) if hw.link_bw else 0.0,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        n_chips=n_chips,
        peak_flops=hw.peak_flops,
    )
