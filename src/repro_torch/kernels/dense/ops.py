"""Wrappers for the dense matrix-free kernels: checks and launch counts.

Inputs are the mode-permuted dense tensor ``x (K, I, J)`` and the
factor-side operands ``c (J, R)`` and ``a (K, R)`` (built by
:mod:`repro_torch.core.dense`), plus ``B (I, R)`` for Φ.  The signatures
are the JAX package's; its TPU tile padding (I to the sublane, J and R to
128 lanes, K to whole ``block_k`` tiles) has no counterpart here.
Results come back in the caller's element dtype (f32, or bf16 rounded
once from the f32 accumulator); f64 and mixed dtypes raise.

A wrapper given tensors on the CPU computes the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`launch_counts` under the kernel's name.
"""
from __future__ import annotations

import torch

from .._checks import MAX_RANK
from ..dtypes import ACC_DTYPE, check_kernel_dtype
from . import kernel, ref

__all__ = ["default_block_k", "launch_counts", "mttkrp_dense", "phi_dense",
           "phi_mu_dense", "reset_launch_counts"]

#: kernel launches per kernel name since the last reset
launch_counts = {"dense_phi": 0, "dense_phi_mu": 0, "dense_mttkrp": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def default_block_k(dt=torch.float32) -> int:
    """Slices of K each CUDA block reduces before its atomics.  Small, so
    that a (128, 256, 128) tensor at the tier's cap splits into 512-1024
    blocks over the 132 SMs; the same for every element dtype."""
    return 2


def _prep(name, x, c, a, b, block_k) -> tuple:
    dt = check_kernel_dtype(name, x, c, a, b)
    ops = [t for t in (x, c, a, b) if t is not None]
    if x.dim() != 3 or c.dim() != 2 or a.dim() != 2:
        raise ValueError(f"{name}: want x (K, I, J), c (J, R), a (K, R); got "
                         f"{[tuple(t.shape) for t in ops]}")
    k, i, j = x.shape
    r = c.shape[1]
    if (c.shape != (j, r) or a.shape != (k, r)
            or (b is not None and b.shape != (i, r))):
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}"
                         + ("" if b is None else f", b {tuple(b.shape)}"))
    if min(k, i, j, r) < 1:
        raise ValueError(f"{name}: empty dimension in x {tuple(x.shape)}, "
                         f"rank {r}")
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"{name}: operands on several devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.device.type == "cuda":
        if r > MAX_RANK:
            raise ValueError(f"{name}: rank {r} outside 1..{MAX_RANK}")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    block_k = default_block_k(dt) if block_k is None else int(block_k)
    if block_k < 1:
        raise ValueError(f"{name}: block_k must be >= 1, got {block_k}")
    return dt, block_k


def _window(x, c) -> torch.Tensor:
    return torch.zeros((x.shape[1], c.shape[1]), dtype=ACC_DTYPE,
                       device=x.device)


def mttkrp_dense(x, c, a, *, block_k: int | None = None) -> torch.Tensor:
    """Matrix-free dense MTTKRP: ``M = sum_k (x[k] @ c) * a[k]``, (I, R)
    in the caller's element dtype."""
    dt, block_k = _prep("dense_mttkrp", x, c, a, None, block_k)
    if x.device.type == "cpu":
        return ref.mttkrp_dense_ref(x, c, a).to(dt)
    out = _window(x, c)
    kernel.launch_mttkrp(x, c, a, out, block_k=block_k)
    launch_counts["dense_mttkrp"] += 1
    return out.to(dt)


def phi_dense(x, c, a, b, *, eps: float = 1e-10,
              block_k: int | None = None) -> torch.Tensor:
    """Dense Φ^(n): Poisson weights against the model slices formed
    in-kernel.  Zero entries contribute zero weight, so it equals the
    sparse strategies' Φ.  Returns (I, R) in the caller's dtype."""
    dt, block_k = _prep("dense_phi", x, c, a, b, block_k)
    if x.device.type == "cpu":
        return ref.phi_dense_ref(x, c, a, b, float(eps)).to(dt)
    phi = _window(x, c)
    kernel.launch_phi(x, c, a, b, phi, block_k=block_k, eps=float(eps))
    launch_counts["dense_phi"] += 1
    return phi.to(dt)


def phi_mu_dense(x, c, a, b, *, eps: float = 1e-10,
                 block_k: int | None = None) -> tuple:
    """Fused dense MU step: ``(mu, viol)`` with ``mu = B * Φ`` (I, R) in
    the caller's dtype and ``viol`` the 0-d f32 KKT violation
    ``max |min(B, 1 - Φ)|``."""
    _, block_k = _prep("dense_phi_mu", x, c, a, b, block_k)
    if x.device.type == "cpu":
        return ref.phi_mu_dense_ref(x, c, a, b, float(eps))
    phi = _window(x, c)
    mu = torch.empty_like(b)
    viol = torch.zeros((), dtype=ACC_DTYPE, device=x.device)
    kernel.launch_phi_mu(x, c, a, b, phi, mu, viol, block_k=block_k,
                         eps=float(eps))
    launch_counts["dense_phi_mu"] += 1
    return mu, viol
