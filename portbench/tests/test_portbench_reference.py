"""The plain reference against a dense float64 CP-APR written here, and
the control's TF32 rounding."""
import numpy as np
import pytest
import torch

from portbench.generators import planted_poisson
from portbench.reference import cpapr_mu as plain

CPU = torch.device("cpu")


def dense_cpapr(x, lam, factors, max_outer, max_inner, tol, eps=1e-10,
                kappa=1e-2, kappa_tol=1e-10):
    """CP-APR MU (Chi & Kolda 2012) on a dense numpy tensor ``x``: Φ^(n) =
    (X_(n) / max(B Π^T, eps)) Π with Π the Khatri-Rao product of the other
    factors, the scooch, the inner MU loop, renormalisation."""
    factors = [np.array(f, np.float64) for f in factors]
    lam = np.array(lam, np.float64)
    for n, f in enumerate(factors):
        s = f.sum(0)
        factors[n] = f / np.where(s > 0, s, 1.0)
        lam = lam * np.where(s > 0, s, 0.0)
    rank = lam.shape[0]
    lls = []
    for _ in range(max_outer):
        worst = 0.0
        for n in range(x.ndim):
            xn = np.moveaxis(x, n, 0).reshape(x.shape[n], -1)
            pi = np.ones((1, rank))
            for m, f in enumerate(factors):
                if m != n:
                    pi = (pi[:, None, :] * f[None, :, :]).reshape(-1, rank)

            def phi(b):
                return (xn / np.maximum(b @ pi.T, eps)) @ pi

            a = factors[n]
            s = np.where((a < kappa_tol) & (phi(a * lam) > 1.0), kappa, 0.0)
            b = (a + s) * lam
            i, viol = 0, np.inf
            while i < max_inner and viol > tol:
                p = phi(b)
                viol = np.abs(np.minimum(b, 1.0 - p)).max()
                if viol > tol:
                    b = b * p
                i += 1
            lam = b.sum(0)
            factors[n] = b / np.maximum(lam, eps)
            worst = max(worst, viol)
        model = np.einsum("r," + ",".join(f"{'ijkl'[m]}r"
                                          for m in range(x.ndim))
                          + "->" + "ijkl"[:x.ndim], lam, *factors)
        nz = x > 0
        lls.append(float(np.sum(x[nz] * np.log(np.maximum(model[nz], eps)))
                         - lam.sum()))
        if worst <= tol:
            break
    return lam, factors, lls


@pytest.mark.parametrize("dims,nnz,rank", [([6, 5, 7], 120, 3),
                                           ([4, 3, 5, 6], 150, 4)])
def test_reference_matches_dense_float64(dims, nnz, rank):
    config = {"name": "tiny", "dims": dims, "nnz": nnz, "planted_rank": 3}
    idx, vals, _ = planted_poisson.make(config, 17, CPU)
    lam0, f0 = planted_poisson.draw_start(dims, rank, 18, CPU)
    x = np.zeros(dims)
    x[tuple(idx.numpy().T)] = vals.numpy()
    ref = plain.cpapr_mu(idx, vals, lam0, f0, max_outer=6, max_inner=10,
                         tol=1e-4, chunk=37)
    lam, factors, lls = dense_cpapr(x, lam0.numpy(), [f.numpy() for f in f0],
                                    6, 10, 1e-4)
    np.testing.assert_allclose(ref["lam"].numpy(), lam, rtol=1e-9)
    for a, b in zip(ref["factors"], factors):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ref["loglik_history"], lls, rtol=1e-9)
    assert ref["n_outer"] == len(lls)
    assert ref["lam"].dtype == torch.float64


def test_control_computes_in_float32_with_tf32_operands():
    config = {"name": "tiny", "dims": [6, 5, 7], "nnz": 120,
              "planted_rank": 3}
    idx, vals, _ = planted_poisson.make(config, 17, CPU)
    lam0, f0 = planted_poisson.draw_start(config["dims"], 3, 18, CPU)
    kw = dict(max_outer=4, max_inner=10, tol=1e-4)
    ref = plain.cpapr_mu(idx, vals, lam0, f0, **kw)
    ctl = plain.cpapr_mu(idx, vals, lam0, f0, control=True, **kw)
    assert ctl["lam"].dtype == torch.float32
    gap = float((ctl["lam"].double() - ref["lam"]).abs().max()
                / ref["lam"].abs().max())
    assert 1e-6 < gap < 1e-2


def test_tf32_round():
    one = 1.0
    x = torch.tensor([one + 2**-11, one + 2**-12, -(one + 2**-11), 3.0,
                      one + 2**-10 + 2**-11], dtype=torch.float32)
    got = plain.tf32_round(x)
    want = torch.tensor([one + 2**-10, one, -(one + 2**-10), 3.0,
                         one + 2**-9], dtype=torch.float32)
    assert torch.equal(got, want)
    r = torch.rand(10_000, generator=torch.Generator().manual_seed(0)) * 100
    q = plain.tf32_round(r)
    assert bool(((q.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((q - r).abs() / r).max()) <= 2**-11
