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
"""
from . import core
from .core import CPAPRConfig, CPAPRResult, cp_als, cpapr_mu

__all__ = ["CPAPRConfig", "CPAPRResult", "core", "cp_als", "cpapr_mu"]
