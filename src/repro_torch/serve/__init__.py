"""Serving on one device: the decomposition service and the LM engine.

:mod:`repro_torch.serve.batch` solves many small cold jobs per padded
bucket; :mod:`repro_torch.serve.decomp` holds the service (cold submits,
batched submits, appends with warm starts, one shared autotune store).
:mod:`repro_torch.serve.engine` serves the LM stack (batched prefill,
then greedy or temperature decode).
"""
from .batch import Bucket, BucketRegistry, batched_cpapr_mu
from .decomp import DecompJob, DecompService, ServiceResult, warm_sweep_budget
from .engine import Engine, ServeConfig

__all__ = ["Bucket", "BucketRegistry", "DecompJob", "DecompService",
           "Engine", "ServeConfig", "ServiceResult", "batched_cpapr_mu",
           "warm_sweep_budget"]
