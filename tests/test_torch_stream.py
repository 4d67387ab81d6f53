"""The port's STREAM op against the JAX package's.

The same numpy-seeded arrays go through the reference's ``stream_op`` (in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and the
port's ``stream_op`` on CPU tensors, where it computes its plain version:
f32 at the reference's own rtol 1e-6 / atol 1e-6, bf16 at ``TOL_BF16``.
Every rejection of the reference's tests holds for the port with the
same ``match=`` strings.  The CUDA kernel itself is held bitwise to the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream import ops as R_ops
from repro.kernels.stream import ref as R_ref

from repro_torch.kernels.stream import ops as P_ops
from repro_torch.kernels.stream import ref as P_ref

from test_conformance import TOL_BF16

STREAM_F32_TOL = dict(rtol=1e-6, atol=1e-6)  # tests/test_kernels.py's
CASES = [(128 * 256, 256), (128 * 512, 64)]  # (n, block_rows), the reference's
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(n, dtype, seed=0):
    """(b, c) as numpy f32 from a seed, then both packages' arrays."""
    rng = np.random.RandomState(seed)
    b, c = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(b, jdt), jnp.asarray(c, jdt)),
            (torch.from_numpy(b).to(tdt), torch.from_numpy(c).to(tdt)))


@pytest.mark.parametrize("dtype", tuple(DTYPES))
@pytest.mark.parametrize("n,block_rows", CASES)
@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_matches_reference(op, n, block_rows, dtype):
    (jb, jc), (tb, tc) = _arrays(n, dtype)
    want = R_ops.stream_op(op, jb, jc, block_rows=block_rows, interpret=True)
    got = P_ops.stream_op(op, tb, tc, block_rows=block_rows)
    assert got.dtype == tb.dtype and got.shape == tb.shape
    assert got.data_ptr() != tb.data_ptr()  # a fresh tensor, even for copy
    tol = STREAM_F32_TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_ref_matches_reference_oracle(op):
    (jb, jc), (tb, tc) = _arrays(128 * 64, "float32", seed=3)
    c_r = jc if op in ("add", "triad") else None
    c_p = tc if op in ("add", "triad") else None
    np.testing.assert_allclose(P_ref.stream_ref(op, tb, c_p, s=-1.5).numpy(),
                               np.asarray(R_ref.stream_ref(op, jb, c_r,
                                                           s=-1.5)),
                               **STREAM_F32_TOL)


def test_stream_ref_rounds_after_each_operation():
    """bf16 triad rounds s*c to bf16 before the add, as the reference's
    ``b + s * c`` does; one fused rounding would differ here."""
    b = torch.full((128,), -1.15625, dtype=torch.bfloat16)
    c = torch.full((128,), -1.765625, dtype=torch.bfloat16)
    got = P_ref.stream_ref("triad", b, c, s=3.0)
    # s*c = -5.296875 rounds to -5.3125 in bf16; b + that = -6.46875,
    # where b + s*c rounded once would give -6.4375
    np.testing.assert_array_equal(got.float().numpy(), np.full(128, -6.46875))
    want = R_ref.stream_ref("triad", jnp.full(128, -1.15625, jnp.bfloat16),
                            jnp.full(128, -1.765625, jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  np.full(128, -6.46875))


B = torch.ones(128 * 256)
REJECTIONS = [
    # (op, args, kwargs, match): tests/test_kernels.py's rejections
    ("copy", (B[:100],), {}, "128-lane"),
    ("copy", (B[: 128 * 8],), dict(block_rows=256), r"128\*block_rows=32768"),
    ("copy", (B.reshape(-1, 128),), {}, "1-D"),
    ("daxpy", (B,), {}, "unknown STREAM op"),
    ("add", (B,), {}, "aliasing"),
    ("triad", (B,), {}, "aliasing"),
    ("add", (B, B[:-128]), {}, "does not match"),
    # the dtype tier: f64 never runs, mixed dtypes name the tier
    ("copy", (B.double(),), {}, "float64"),
    ("add", (B, B.to(torch.bfloat16)), {}, "share one element dtype"),
    ("copy", (B,), dict(block_rows=0), "block_rows must be >= 1"),
]


@pytest.mark.parametrize("op,args,kwargs,match", REJECTIONS)
def test_stream_rejects_like_the_reference(op, args, kwargs, match):
    with pytest.raises(ValueError, match=match):
        P_ops.stream_op(op, *args, **kwargs)


@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_raises_on_f64_like_the_reference(op):
    b = np.ones(128 * 256)
    with pytest.raises(ValueError, match="float64"):
        P_ops.stream_op(op, torch.from_numpy(b), torch.from_numpy(b))


def test_stream_tile_multiple_and_one_array_ops():
    out = P_ops.stream_op("scale", torch.ones(128 * 8), block_rows=8, s=2.0)
    np.testing.assert_array_equal(out.numpy(), np.full(128 * 8, 2.0))
    np.testing.assert_array_equal(P_ops.stream_op("copy", B).numpy(),
                                  B.numpy())


def test_stream_on_the_cpu_counts_no_launch():
    before = dict(P_ops.launch_counts)
    P_ops.stream_op("triad", B, B.clone())
    assert P_ops.launch_counts == before


@pytest.mark.parametrize("itemsize", (2, 4, 8))
@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_bytes_flops_equal(op, itemsize):
    for n in (0, 128, 1 << 28):
        assert P_ref.stream_bytes_flops(op, n, itemsize) == \
            R_ref.stream_bytes_flops(op, n, itemsize)


@pytest.mark.parametrize("block_rows", (1, 3, 5))
@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_odd_tile_counts_match_reference(op, block_rows):
    """n = 128*block_rows*k for odd k: lengths whose vectors do not fill
    the kernel's last CTA (its launch shape ignores block_rows)."""
    for k_tiles in (1, 3, 7):
        n = 128 * block_rows * k_tiles
        (jb, jc), (tb, tc) = _arrays(n, "float32", seed=k_tiles)
        want = R_ops.stream_op(op, jb, jc, block_rows=block_rows,
                               interpret=True, s=0.7)
        got = P_ops.stream_op(op, tb, tc, block_rows=block_rows, s=0.7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STREAM_F32_TOL)


@pytest.mark.parametrize("op", P_ops.STREAM_OPS)
def test_stream_odd_tile_counts_match_reference_bf16(op):
    """The odd tile counts in bf16 (8 elements per 16-byte vector), where
    triad rounds its product to bf16 before the add."""
    for block_rows, k_tiles in ((1, 3), (3, 5), (5, 7)):
        n = 128 * block_rows * k_tiles
        (jb, jc), (tb, tc) = _arrays(n, "bfloat16", seed=k_tiles)
        want = R_ops.stream_op(op, jb, jc, block_rows=block_rows,
                               interpret=True, s=0.7)
        got = P_ops.stream_op(op, tb, tc, block_rows=block_rows, s=0.7)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **TOL_BF16)
