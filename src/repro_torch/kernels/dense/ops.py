"""Wrappers for the dense matrix-free kernels: checks and launch counts.

Inputs are the mode-permuted dense tensor ``x (K, I, J)`` and the
factor-side operands ``c (J, R)`` and ``a (K, R)`` (built by
:mod:`repro_torch.core.dense`), plus ``B (I, R)`` for Φ.  The signatures
are the JAX package's; its TPU tile padding (I to the sublane, J and R to
128 lanes, K to whole ``block_k`` tiles) has no counterpart here.
Results come back in the caller's element dtype (f32, or bf16 rounded
once from the f32 accumulator); f64 and mixed dtypes raise.  On the card
each call is one kernel launch (the fused step also zeroes its 4-byte
viol), and its results are bitwise the same from run to run.

A wrapper given tensors on the CPU computes the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.  Each
launch adds one to :data:`launch_counts` under the kernel's name.
"""
from __future__ import annotations

import torch

from .._checks import MAX_RANK, SMEM_LIMIT
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
    """The reference's K-tile argument (slices per grid step of the TPU
    kernels), kept in the wrappers' signatures and checked (>= 1).  The
    CUDA kernel does not use it: its split of K over CTAs is sized for the
    card by :func:`repro_torch.kernels.dense.kernel.launch_shape`, and
    every result is the same whatever block_k says.  The same for every
    element dtype."""
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
    block_k = default_block_k(dt) if block_k is None else int(block_k)
    if block_k < 1:
        raise ValueError(f"{name}: block_k must be >= 1, got {block_k}")
    if x.device.type == "cpu":
        return dt, None
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if r > MAX_RANK:
        raise ValueError(f"{name}: rank {r} outside 1..{MAX_RANK}")
    shape = kernel.launch_shape(k, i, j, r, dt, name)
    if shape.smem > SMEM_LIMIT:
        raise ValueError(f"{name}: rank {r} needs {shape.smem} bytes of "
                         f"shared memory per block (limit {SMEM_LIMIT})")
    return dt, shape


def _window(x, c) -> torch.Tensor:
    return torch.empty((x.shape[1], c.shape[1]), dtype=ACC_DTYPE,
                       device=x.device)


def mttkrp_dense(x, c, a, *, block_k: int | None = None) -> torch.Tensor:
    """Matrix-free dense MTTKRP: ``M = sum_k (x[k] @ c) * a[k]``, (I, R)
    in the caller's element dtype."""
    dt, shape = _prep("dense_mttkrp", x, c, a, None, block_k)
    if shape is None:
        return ref.mttkrp_dense_ref(x, c, a).to(dt)
    out = _window(x, c)
    part, tickets = kernel.workspace(shape, x.device)
    kernel.launch_mttkrp(x, c, a, out, part, tickets, shape)
    launch_counts["dense_mttkrp"] += 1
    return out.to(dt)


def phi_dense(x, c, a, b, *, eps: float = 1e-10,
              block_k: int | None = None) -> torch.Tensor:
    """Dense Φ^(n): Poisson weights against the model slices formed
    in-kernel.  Zero entries contribute zero weight, so it equals the
    sparse strategies' Φ.  Returns (I, R) in the caller's dtype."""
    dt, shape = _prep("dense_phi", x, c, a, b, block_k)
    if shape is None:
        return ref.phi_dense_ref(x, c, a, b, float(eps)).to(dt)
    phi = _window(x, c)
    part, tickets = kernel.workspace(shape, x.device)
    kernel.launch_phi(x, c, a, b, phi, part, tickets, shape, eps=float(eps))
    launch_counts["dense_phi"] += 1
    return phi.to(dt)


def phi_mu_dense(x, c, a, b, *, eps: float = 1e-10,
                 block_k: int | None = None) -> tuple:
    """Fused dense MU step: ``(mu, viol)`` with ``mu = B * Φ`` (I, R) in
    the caller's dtype and ``viol`` the 0-d f32 KKT violation
    ``max |min(B, 1 - Φ)|``."""
    _, shape = _prep("dense_phi_mu", x, c, a, b, block_k)
    if shape is None:
        return ref.phi_mu_dense_ref(x, c, a, b, float(eps))
    mu = torch.empty_like(b)
    viol = torch.zeros((), dtype=ACC_DTYPE, device=x.device)
    part, tickets = kernel.workspace(shape, x.device)
    kernel.launch_phi_mu(x, c, a, b, mu, viol, part, tickets, shape,
                         eps=float(eps))
    launch_counts["dense_phi_mu"] += 1
    return mu, viol
