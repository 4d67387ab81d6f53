"""Plain CP-ALS (Kolda & Bader 2009, Sec. 3.4, Fig. 3.3) on a sparse COO
tensor.

The benchmark's reference for the ``cp_als`` traffic: plain PyTorch
operations on the COO tensor and the starting model the benchmark made,
nothing of the program under test.  The start's weights are folded into
its first factor.  Each iteration updates every mode n in turn from the
current factors (Gauss-Seidel order):

    M_n = X_(n) (A_N ⊙ ... ⊙ A_{n+1} ⊙ A_{n-1} ⊙ ... ⊙ A_1)     (MTTKRP)
    A_n <- M_n (∗_{m≠n} A_m^T A_m + 1e-10 I)^{-1}

MTTKRP gathers the Khatri-Rao rows of the other factors at the nonzeros,
in blocks of ``chunk`` nonzeros so that they fit beside a cell's tensor,
and sums each nonzero's row times its value into its mode-n row with an
``index_add_``: no sort is needed.  The 1e-10 ridge on the Gram matrix is
not textbook ALS: it is the program's regulariser, kept so that both
solve the same normal equations.  After each iteration the fit
1 - |X - M| / |X| is recorded, with |X - M|^2 = |X|^2 - 2 <X, M> + |M|^2,
|M|^2 the sum of the Hadamard product of every factor's Gram matrix and
<X, M> the sum over the nonzeros of x times the model's value there.  At
the end every factor column is scaled to unit sum, the scale folded into
the weights (which start at one); a column whose sum is not positive is
left as it is and its weight set to zero.

The reference computes in float64, so that its own rounding stays far
below the float32 the configurations state.  ``control=True`` computes as
TF32 matrix units would: float32 throughout, the operands of MTTKRP's
reduction (each nonzero's value and Khatri-Rao row) and of every Gram
product rounded to TF32's 10-bit mantissa, float32 sums.
"""
from __future__ import annotations

import torch

from .cpapr_mu import _pi as _krao
from .cpapr_mu import _same, tf32_round

__all__ = ["RIDGE", "cp_als", "model_values"]

#: the Gram matrix's regulariser, the program's
RIDGE = 1e-10


def _mttkrp(indices, values, factors, n: int, chunk: int, q) -> torch.Tensor:
    out = torch.zeros_like(factors[n])
    nnz = values.shape[0]
    for lo in range(0, nnz, chunk):
        hi = min(lo + chunk, nnz)
        kr = _krao(indices, factors, n, lo, hi)
        out.index_add_(0, indices[lo:hi, n], q(values[lo:hi])[:, None] * q(kr))
    return out


def _gram(f: torch.Tensor, q) -> torch.Tensor:
    fq = q(f)
    return fq.T @ fq


def model_values(indices: torch.Tensor, lam: torch.Tensor, factors,
                 chunk: int = 1 << 22) -> torch.Tensor:
    """The model's values at the nonzeros, sum_r lam_r prod_n A_n[i_n, r],
    in float64."""
    lam = lam.to(indices.device).double()
    factors = [f.to(indices.device).double() for f in factors]
    nnz = indices.shape[0]
    return torch.cat([_krao(indices, factors, -1, lo, min(lo + chunk, nnz))
                      @ lam for lo in range(0, nnz, chunk)])


def _fit_score(indices, values, factors, norm_x, chunk: int, q) -> float:
    rank = factors[0].shape[1]
    gram = torch.ones((rank, rank), dtype=values.dtype, device=values.device)
    for f in factors:
        gram = gram * _gram(f, q)
    inner = 0.0
    nnz = values.shape[0]
    for lo in range(0, nnz, chunk):
        hi = min(lo + chunk, nnz)
        inner = inner + torch.sum(values[lo:hi] * torch.sum(
            _krao(indices, factors, -1, lo, hi), dim=1))
    resid_sq = torch.clamp_min(norm_x ** 2 - 2 * inner + torch.sum(gram), 0.0)
    return float(1.0 - torch.sqrt(resid_sq) / norm_x)


def cp_als(indices: torch.Tensor, values: torch.Tensor, lam0: torch.Tensor,
           factors0, *, n_iters: int, control: bool = False,
           chunk: int = 1 << 23) -> dict:
    """Fit from the start ``(lam0, factors0)``.  Returns ``lam``,
    ``factors`` (unit column sums) and ``fits`` (one per iteration)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _als(indices, values, lam0, list(factors0), n_iters,
                    torch.float32 if control else torch.float64,
                    tf32_round if control else _same, chunk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _als(indices, values, lam, factors, n_iters, dtype, q, chunk) -> dict:
    values = values.to(dtype)
    factors = [f.to(dtype) for f in factors]
    factors[0] = factors[0] * lam.to(dtype)[None, :]
    rank = factors[0].shape[1]
    eye = torch.eye(rank, dtype=dtype, device=values.device)
    norm_x = torch.sqrt(torch.sum(values ** 2))
    fits = []
    for _ in range(n_iters):
        for n in range(len(factors)):
            m_n = _mttkrp(indices, values, factors, n, chunk, q)
            gram = torch.ones((rank, rank), dtype=dtype, device=values.device)
            for m, f in enumerate(factors):
                if m != n:
                    gram = gram * _gram(f, q)
            factors[n] = torch.linalg.solve(gram + RIDGE * eye, m_n.T).T
        fits.append(_fit_score(indices, values, factors, norm_x, chunk, q))
    lam = torch.ones((rank,), dtype=dtype, device=values.device)
    for n, f in enumerate(factors):
        colsum = torch.sum(f, dim=0)
        factors[n] = f / torch.where(colsum > 0, colsum,
                                     torch.ones_like(colsum))
        lam = lam * torch.where(colsum > 0, colsum, torch.zeros_like(colsum))
    return {"lam": lam, "factors": factors, "fits": fits}
