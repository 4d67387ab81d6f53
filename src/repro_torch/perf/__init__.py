"""Performance-portability methodology layer (the paper's analysis tooling).

  roofline — paper Eqs. 1-8 + the 3-term roofline, with the H100's rates
  ppa      — pressure-point analysis harness (Sec. 3.3)
  comm     — the sharded and grid tiers' communication model (wire bounds,
             dense operand counts) and its evidence: the recorded
             collectives and per-rank operand bytes
  timing   — CUDA-event timing and the fenced median harness
  trace    — torch.profiler breakdown of one solve (run as a module)
  autotune — the persistent parallel-policy autotuner (JSON-cached
             CUDA-graph burst probes; backs ``CPAPRConfig(policy="auto")``)
"""
from .autotune import Autotuner, AutotuneCache, default_cache_path, policy_key
from .comm import (
    Collective,
    CollectiveStats,
    allreduce_wire_bytes,
    collective_stats,
    dense_input_bytes,
    dense_mttkrp_flops,
    dense_pad_dims,
    entry_parameter_bytes,
    grid_combine_wire_bound,
    mttkrp_comm_lower_bound,
    phi_combine_wire_bound,
    phi_reduce_scatter_wire_bound,
    pi_gather_wire_bound,
    pi_replicated_gather_bytes,
    record_collectives,
    reduce_scatter_wire_bytes,
    shape_bytes,
)
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
    "Collective",
    "CollectiveStats",
    "HARDWARE",
    "PAPER_STATED_INTENSITY",
    "PERTURBATIONS",
    "HardwareSpec",
    "PPAResult",
    "RooflineTerms",
    "allreduce_wire_bytes",
    "attainable_gflops",
    "bandwidth_gbs",
    "bench_burst_seconds",
    "bench_seconds",
    "collective_stats",
    "cuda_ms",
    "default_cache_path",
    "dense_input_bytes",
    "dense_mttkrp_flops",
    "dense_pad_dims",
    "detect_hardware_spec",
    "entry_parameter_bytes",
    "grid_combine_wire_bound",
    "mttkrp_comm_lower_bound",
    "operational_intensity_phi",
    "phi_combine_wire_bound",
    "phi_reduce_scatter_wire_bound",
    "pi_gather_wire_bound",
    "pi_replicated_gather_bytes",
    "policy_key",
    "record_collectives",
    "reduce_scatter_wire_bytes",
    "roofline_terms",
    "run_ppa",
    "shape_bytes",
]
