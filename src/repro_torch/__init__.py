"""PyTorch/CUDA port of the CP-APR tensor-decomposition package ``repro``.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Its entry points run on the card (``device="cuda"``) unless
the caller asks for ``device="cpu"``, where the kernels' plain versions
run.  It holds the single-device CP-APR MU solve
(:func:`repro_torch.core.cpapr_mu`) with Φ and the fused Φ -> MU step as
hand-written CUDA kernels (:mod:`repro_torch.kernels.phi`), CP-ALS
(:func:`repro_torch.core.cp_als`) with the sparse MTTKRP kernel
(:mod:`repro_torch.kernels.mttkrp`), and the dense matrix-free tier
(``strategy="dense"`` in both solvers, :mod:`repro_torch.kernels.dense`).
Both solvers run under the fault-tolerant runtime
(:mod:`repro_torch.core.resilience`: the degradation ladder, and for
CP-APR checkpoints and resume) and take ``policy="auto"``, the persistent
autotuner (:mod:`repro_torch.perf.autotune`).  The multi-tenant
decomposition service (:mod:`repro_torch.serve`) drives CP-APR for many
tenants: batched cold jobs, appends with warm starts, one shared tuner.
The LM stack's serving path (:mod:`repro_torch.models`, the ten
architectures of :mod:`repro_torch.configs`, and
:class:`repro_torch.serve.engine.Engine`) serves batched prefill and
decode in plain PyTorch; it reaches none of the CUDA kernels.
"""
from . import core
from .core import CPAPRConfig, CPAPRResult, cp_als, cpapr_mu

__all__ = ["CPAPRConfig", "CPAPRResult", "core", "cp_als", "cpapr_mu"]
