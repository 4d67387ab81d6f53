"""The port's log-depth RG-LRU scan against the JAX package's, on the CPU.

``repro_torch.models.scan.associative_scan`` follows the recursion of
``jax.lax.associative_scan``, so with the RG-LRU combine it is bitwise
equal to the eager JAX scan at every length (odd tails included).  XLA's
CPU backend flushes subnormal floats to zero; the decay products ``a``
underflow into that range after a few hundred steps, so the port's side
runs with ``torch.set_flush_denormal(True)`` for the bitwise comparison.

``rg_lru`` (forward, final state and the gradients of every input) is held
against the reference's ``rg_lru`` and ``jax.grad`` of it at ``TOL``, and
its forward + backward is held to a log-depth number of aten ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import rglru as R_rglru

from repro_torch.models import rglru as P_rglru
from repro_torch.models.scan import associative_scan

TOL = dict(rtol=3e-5, atol=1e-5)
LRU_KEYS = ("w_a", "b_a", "w_x", "b_x", "lam")


@pytest.fixture
def flush_denormal():
    """Subnormals flushed to zero, as XLA's CPU backend does."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _coeffs(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("s", (1, 2, 3, 7, 13, 64, 1000))
def test_scan_bitwise_eager_jax(s, flush_denormal):
    a, b = _coeffs(s, (2, s, 8))
    with jax.disable_jit():
        want = jax.lax.associative_scan(
            combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = associative_scan(combine, (torch.from_numpy(a),
                                     torch.from_numpy(b)), dim=1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dim", (0, -1))
def test_scan_other_dims_bitwise(dim):
    """The recursion on another axis: a noncommutative combine (affine
    maps composed) over 11 entries, as in the JAX scan."""
    a, b = _coeffs(11, (11, 3, 11))
    with jax.disable_jit():
        want = jax.lax.associative_scan(
            combine, (jnp.asarray(a), jnp.asarray(b)), axis=dim)
    got = associative_scan(combine, (torch.from_numpy(a),
                                     torch.from_numpy(b)), dim=dim)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _lru_inputs(seed, bsz, s, w, with_h0):
    rng = np.random.default_rng(seed)

    def f(*shape, sc=1.0):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    x = f(bsz, s, w)
    p = {"w_a": f(w, w, sc=0.1 / w ** 0.5), "b_a": f(w, sc=0.1),
         "w_x": f(w, w, sc=0.1 / w ** 0.5), "b_x": f(w, sc=0.1),
         "lam": f(w)}
    h0 = f(bsz, w) if with_h0 else None
    gy, gh = f(bsz, s, w), f(bsz, w)  # cotangents of y and h_last
    return x, p, h0, gy, gh


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("s", (24, 4096))
def test_rg_lru_and_grads_match_reference(s, with_h0):
    bsz, w = 2, 16
    x, p, h0, gy, gh = _lru_inputs(s + with_h0, bsz, s, w, with_h0)

    def r_loss(x, p, h0):
        y, h = R_rglru.rg_lru(x, p, h0)
        return jnp.sum(y * gy) + jnp.sum(h * gh), (y, h)

    argnums = (0, 1, 2) if with_h0 else (0, 1)
    (_, (want_y, want_h)), want_g = jax.jit(
        jax.value_and_grad(r_loss, argnums=argnums, has_aux=True))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p),
        None if h0 is None else jnp.asarray(h0))

    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    y, h = P_rglru.rg_lru(tx, tp, th0)
    (torch.sum(y * torch.from_numpy(gy))
     + torch.sum(h * torch.from_numpy(gh))).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[0]), **TOL)
    for k in LRU_KEYS:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(want_g[1][k]), err_msg=k, **TOL)
    if with_h0:
        np.testing.assert_allclose(th0.grad.numpy(), np.asarray(want_g[2]),
                                   **TOL)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_rg_lru_op_count_is_log_depth():
    """Forward + backward at S = 4096: a few hundred aten ops (the
    sequential loop issues ~49k)."""
    x, p, h0, gy, gh = _lru_inputs(7, 2, 4096, 16, True)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    th0 = torch.from_numpy(h0).requires_grad_()
    with _OpCount() as count:
        y, h = P_rglru.rg_lru(tx, tp, th0)
        (y.sum() + h.sum()).backward()
    assert count.n <= 1500, count.n
    assert tx.grad is not None and th0.grad is not None
