"""Element-dtype policy shared by every CUDA kernel entry point.

The kernels compute in the caller's *element* dtype and accumulate in
f32; results are rounded back to the caller's dtype exactly once at the
wrapper boundary.  Two element tiers exist:

* ``float32`` — the default.
* ``bfloat16`` — the mixed-precision tier (bf16 elements, f32
  accumulation), held to its own tolerance tier in the tests.

Anything else raises instead of silently downcasting: f64 callers get a
``ValueError`` pointing at the plain strategies (scatter/segment/blocked),
which keep f64 end to end.
"""
from __future__ import annotations

import torch

__all__ = ["SUPPORTED_KERNEL_DTYPES", "ACC_DTYPE", "check_kernel_dtype"]

#: element dtypes the kernels accept (compute dtype == input dtype)
SUPPORTED_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: accumulator dtype — pinned, never the element dtype
ACC_DTYPE = torch.float32


def check_kernel_dtype(name: str, *tensors) -> torch.dtype:
    """Common element dtype of ``tensors``, validated for the kernel tier.

    Returns the shared dtype; raises ``ValueError`` when operands mix
    dtypes (the caller must state the precision tier explicitly), when
    the dtype is f64 (no silent downcast — use a plain strategy), or when
    the dtype is outside :data:`SUPPORTED_KERNEL_DTYPES`.
    """
    dts = {t.dtype for t in tensors if t is not None}
    if len(dts) != 1:
        raise ValueError(
            f"{name}: operands must share one element dtype, got "
            f"{sorted(str(d).replace('torch.', '') for d in dts)}; cast "
            f"inputs to the intended precision tier before the call"
        )
    (dt,) = dts
    if dt == torch.float64:
        raise ValueError(
            f"{name}: float64 is not supported by the CUDA kernels and "
            f"is never silently downcast to float32; use "
            f"strategy='scatter'/'segment'/'blocked' for f64 solves"
        )
    if dt not in SUPPORTED_KERNEL_DTYPES:
        raise ValueError(
            f"{name}: unsupported element dtype {dt}; supported tiers: "
            f"{[str(d) for d in SUPPORTED_KERNEL_DTYPES]}"
        )
    return dt
