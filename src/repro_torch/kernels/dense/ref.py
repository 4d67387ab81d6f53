"""Plain PyTorch versions of the dense kernels (same function, same rounding).

On the mode-permuted dense tensor ``x (K, I, J)`` with ``c (J, R)``,
``a (K, R)`` and ``B (I, R)``:

    MTTKRP:  M[i, r]   = sum_k a[k, r] * sum_j x[k, i, j] * c[j, r]
    Φ:       m_k       = B (c∘a_k)^T                       (I, J), f32
             w_k       = x_k > 0 ? x_k / max(m_k, eps) : 0
             Φ[i, r]   = sum_k a[k, r] * sum_j w_k[i, j] * c[j, r]

They follow the TPU kernels' bodies slice by slice, with their element-
dtype roundings: ``c∘a_k`` is rounded to the element dtype before the
first contraction, ``w`` is rounded to ``c``'s dtype before the second,
and every contraction accumulates in f32.  For f32 inputs the roundings
are the identity.  The wrappers in :mod:`repro_torch.kernels.dense.ops`
take these for CPU tensors, and the tests and ``chip_smoke.py`` hold the
CUDA kernels against them; the sums run in another order than the
kernels', so the two agree to a tolerance, not bitwise.
"""
from __future__ import annotations

import torch

from ..phi.ref import _acc, _mu_epilogue_ref

__all__ = ["mttkrp_dense_ref", "phi_dense_ref", "phi_mu_dense_ref"]


def mttkrp_dense_ref(x, c, a) -> torch.Tensor:
    """Dense MTTKRP, (I, R) in the accumulator dtype."""
    acc = _acc(x.dtype)
    t = torch.einsum("kij,jr->kir", x.to(acc), c.to(acc))
    return (t * a.to(acc)[:, None, :]).sum(dim=0)


def phi_dense_ref(x, c, a, b, eps: float) -> torch.Tensor:
    """Dense Φ^(n), (I, R) in the accumulator dtype."""
    acc = _acc(x.dtype)
    ca = (c[None, :, :] * a[:, None, :]).to(acc)  # (K, J, R), element-rounded
    m = torch.einsum("ir,kjr->kij", b.to(acc), ca)
    xk = x.to(acc)
    w = torch.where(xk > 0, xk / torch.clamp_min(m, eps), torch.zeros_like(xk))
    w = w.to(c.dtype).to(acc)
    t = torch.einsum("kij,jr->kir", w, c.to(acc))
    return (t * a.to(acc)[:, None, :]).sum(dim=0)


def phi_mu_dense_ref(x, c, a, b, eps: float) -> tuple:
    """Fused dense MU step: ``(B*Φ in B's dtype, f32 max|min(B, 1-Φ)|)``."""
    return _mu_epilogue_ref(b, phi_dense_ref(x, c, a, b, eps))
