"""Performance-portability methodology layer (the paper's analysis tooling).

  roofline — paper Eqs. 1-8 + the 3-term roofline, with the H100's rates
  ppa      — pressure-point analysis harness (Sec. 3.3)
  timing   — CUDA-event timing and the fenced median harness
  trace    — torch.profiler breakdown of one solve (run as a module)
  autotune — the persistent parallel-policy autotuner (JSON-cached
             CUDA-graph burst probes; backs ``CPAPRConfig(policy="auto")``)
"""
from .autotune import Autotuner, AutotuneCache, default_cache_path, policy_key
from .ppa import PERTURBATIONS, PPAResult, run_ppa
from .roofline import (
    HARDWARE,
    PAPER_STATED_INTENSITY,
    HardwareSpec,
    RooflineTerms,
    attainable_gflops,
    detect_hardware_spec,
    operational_intensity_phi,
    roofline_terms,
)
from .timing import bandwidth_gbs, bench_burst_seconds, bench_seconds, cuda_ms

__all__ = [
    "AutotuneCache",
    "Autotuner",
    "HARDWARE",
    "PAPER_STATED_INTENSITY",
    "PERTURBATIONS",
    "HardwareSpec",
    "PPAResult",
    "RooflineTerms",
    "attainable_gflops",
    "bandwidth_gbs",
    "bench_burst_seconds",
    "bench_seconds",
    "cuda_ms",
    "default_cache_path",
    "detect_hardware_spec",
    "operational_intensity_phi",
    "policy_key",
    "roofline_terms",
    "run_ppa",
]
