"""The multi-tenant decomposition service on one device.

:mod:`repro_torch.serve.batch` solves many small cold jobs per padded
bucket; :mod:`repro_torch.serve.decomp` holds the service (cold submits,
batched submits, appends with warm starts, one shared autotune store).
The JAX package's LM serving engine is ROADMAP A11.
"""
from .batch import Bucket, BucketRegistry, batched_cpapr_mu
from .decomp import DecompJob, DecompService, ServiceResult, warm_sweep_budget

__all__ = ["Bucket", "BucketRegistry", "DecompJob", "DecompService",
           "ServiceResult", "batched_cpapr_mu", "warm_sweep_budget"]
