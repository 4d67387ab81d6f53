"""Plain CP-APR multiplicative update (Chi & Kolda 2012; paper Algs. 1-2).

The benchmark's reference for the ``cpapr_mu`` traffic: plain PyTorch
operations on the COO tensor and the starting model the benchmark made,
nothing of the program under test.  For every mode update it forms the
Khatri-Rao rows Π from the other factors, lifts inadmissible zeros (the
scooch), runs the inner MU loop

    Φ <- (X_(n) (/) max(B Π, eps)) Π^T;  viol = max |min(B, 1 - Φ)|;
    stop when viol <= tol (that iteration leaves B unchanged), else B <- B * Φ

for at most ``max_inner`` iterations, and renormalises (lam <- e^T B,
A^(n) <- B / lam).  A sweep updates every mode once; the log-likelihood
sum x log m - sum(lam) is recorded after each sweep, and the solve ends
after ``max_outer`` sweeps or once a sweep's largest violation is at most
``tol``.  No sort is needed: Φ is an ``index_add_`` over the nonzeros in
COO order, in blocks of ``chunk`` nonzeros so that it fits beside a cell's
tensor.

The reference computes in float64, so that its own rounding stays far
below the float32 the configurations state: an ``index_add_`` in float32
over a hub row (uber's 24-row mode holds ~138k nonzeros a row) rounds as
much as a whole solve of the port departs from the exact result.
``control=True`` computes as TF32 matrix units would: float32 throughout,
the operands of every product that reduces over the rank or the nonzeros
(B Π and Φ) rounded to TF32's 10-bit mantissa, float32 sums.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cpapr_mu", "tf32_round"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest with
    ties away from zero (the conversion the matrix units apply)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _pi(indices, factors, skip: int, lo: int, hi: int) -> torch.Tensor:
    """Khatri-Rao rows of nonzeros ``lo:hi``: the product of every factor's
    row but mode ``skip``'s (``skip=-1``: all modes)."""
    out = None
    for m, f in enumerate(factors):
        if m == skip:
            continue
        rows = f[indices[lo:hi, m]]
        out = rows if out is None else out * rows
    return out


def _phi(indices, values, pis, n: int, b: torch.Tensor, eps: float,
         q) -> torch.Tensor:
    """Φ^(n) of ``b``: sum over the nonzeros of x / max(b_i . π, eps) π."""
    out = torch.zeros_like(b)
    for lo, pi in pis:
        hi = lo + pi.shape[0]
        rows = indices[lo:hi, n]
        d = torch.sum(q(b[rows]) * q(pi), dim=1)
        w = values[lo:hi] / torch.clamp_min(d, eps)
        out.index_add_(0, rows, q(w)[:, None] * q(pi))
    return out


def _loglik(indices, values, lam, factors, eps: float, chunk: int) -> float:
    total = 0.0
    for lo in range(0, values.shape[0], chunk):
        hi = min(lo + chunk, values.shape[0])
        m = torch.sum(_pi(indices, factors, -1, lo, hi) * lam[None, :], dim=1)
        total += float(torch.sum(values[lo:hi]
                                 * torch.log(torch.clamp_min(m, eps))))
    return total - float(torch.sum(lam))


def cpapr_mu(indices: torch.Tensor, values: torch.Tensor, lam0: torch.Tensor,
             factors0, *, max_outer: int, max_inner: int, tol: float,
             eps: float = 1e-10, kappa: float = 1e-2,
             kappa_tol: float = 1e-10, control: bool = False,
             chunk: int = 1 << 23) -> dict:
    """Fit from the start ``(lam0, factors0)`` (normalised first, as any
    start is).  Returns ``lam``, ``factors``, ``loglik_history``,
    ``kkt_history``, ``inner_iters`` (per sweep, over the modes) and
    ``n_outer``."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _fit(indices, values, lam0, list(factors0), max_outer,
                    max_inner, tol, eps, kappa, kappa_tol,
                    torch.float32 if control else torch.float64,
                    tf32_round if control else _same, chunk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _fit(indices, values, lam, factors, max_outer, max_inner, tol, eps,
         kappa, kappa_tol, dtype, q, chunk) -> dict:
    values = values.to(dtype)
    lam = lam.to(dtype)
    factors = [f.to(dtype) for f in factors]
    for n, f in enumerate(factors):
        colsum = torch.sum(f, dim=0)
        factors[n] = f / torch.where(colsum > 0, colsum,
                                     torch.ones_like(colsum))
        lam = lam * torch.where(colsum > 0, colsum, torch.zeros_like(colsum))
    nnz = values.shape[0]
    ll_hist, kkt_hist, inner_hist = [], [], []
    n_outer = 0
    for _ in range(max_outer):
        n_outer += 1
        worst, inner_total = 0.0, 0
        for n in range(len(factors)):
            pis = [(lo, _pi(indices, factors, n, lo, min(lo + chunk, nnz)))
                   for lo in range(0, nnz, chunk)]
            a = factors[n]
            phi0 = _phi(indices, values, pis, n, a * lam[None, :], eps, q)
            s = torch.where((a < kappa_tol) & (phi0 > 1.0),
                            torch.full_like(a, kappa), torch.zeros_like(a))
            b = (a + s) * lam[None, :]
            i, viol = 0, math.inf
            while i < max_inner and viol > tol:
                phi = _phi(indices, values, pis, n, b, eps, q)
                viol = float(torch.max(torch.abs(torch.minimum(b, 1.0 - phi))))
                if viol > tol:
                    b = b * phi
                i += 1
            del pis
            lam = torch.sum(b, dim=0)
            factors[n] = b / torch.clamp_min(lam, eps)
            worst = max(worst, viol)
            inner_total += i
        kkt_hist.append(worst)
        inner_hist.append(inner_total)
        ll_hist.append(_loglik(indices, values, lam, factors, eps, chunk))
        if worst <= tol:
            break
    return {"lam": lam, "factors": factors, "loglik_history": ll_hist,
            "kkt_history": kkt_hist, "inner_iters": inner_hist,
            "n_outer": n_outer}
