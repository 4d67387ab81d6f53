"""The port's communication model (``repro_torch/perf/comm.py``) against
the JAX package's (``repro/perf/hlo.py``).

  * Every analytic function (the ring factors, the Φ-combine, owner
    reduce-scatter, grid and Π-gather bounds, the Ballard/Knight/Rouse
    lower bound, the dense tier's pad, FLOP and operand counts) equals the
    reference's bit for bit, on a grid that takes in one-participant
    groups, row blocks wider than the mode, itemsizes 2, 4 and 8 and every
    ``padded``/``with_b`` pair, and on one ``hypothesis`` property per
    bound, each with the relation its docstring states;
  * ``shape_bytes`` reads the reference's HLO types as the reference does,
    and the port's type strings of tensors back to their bytes;
  * ``collective_stats`` of a recorded log equals the reference's
    ``collective_stats`` of HLO lines built from the same ops (explicit and
    iota ``replica_groups``, an async start/done pair, the fallback ring
    size);
  * ``record_collectives`` logs the sharded tier's collectives on a
    one-rank gloo group and swallows no error, and does nothing outside
    its block; ``entry_parameter_bytes`` counts a DTensor's local shard;
  * the port's dense wrappers hand their kernel's plain version exactly
    ``dense_input_bytes`` (``padded=False``: the port pads nothing) on the
    reference's near-dense 4-way tensor, in f32 and bf16.

The multi-rank checks (the recorded wire of both combines, the grid and
the Π gather held to the model on 2 and 4 gloo ranks) are in
``tests/test_torch_dist.py`` and ``tests/test_torch_grid_dist.py``.
"""
import contextlib
import itertools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.perf.hlo as R
from repro.core.sparse_tensor import random_poisson_tensor

from repro_torch.core import distributed as P_dist
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.dense import build_dense_mode
from repro_torch.core.layout import (
    build_blocked_layout,
    owner_partition,
    shard_blocked_layout,
)
from repro_torch.core.phi import _dense_operands, expand_to_shards
from repro_torch.core.pi import pi_rows
from repro_torch.core.sparse_tensor import sort_mode
from repro_torch.kernels.dense import ops as dense_ops
from repro_torch.kernels.dense import ref as dense_ref
from repro_torch.perf import comm as P

from test_conformance import BN, BR, RANK, make_fixture

ITEMSIZES = (2, 4, 8)
PROPERTY = settings(max_examples=60, deadline=None)
ints = st.integers


# ---------------------------------------------------------------------------
# The analytic model, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("n", (0, 1, 2, 3, 4, 8, 256))
def test_ring_wire_bytes_equal_the_reference(n, itemsize):
    for size in (0.0, 1.0, 4096.0 * itemsize, 12345.0):
        assert P.allreduce_wire_bytes(size, n) == \
            R.allreduce_wire_bytes(size, n)
        assert P.reduce_scatter_wire_bytes(size, n) == \
            R.reduce_scatter_wire_bytes(size, n)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        if n >= 1:
            assert P._wire_factor(kind, n) == R._wire_factor(kind, n)


# (n_rows, rank, n_shards, block_rows): a mode under one row block,
# block_rows > n_rows, one shard, a non-power-of-two shard count
COMBINE_CASES = ((1, 1, 1, 256), (24, 16, 2, 256), (300, 4, 4, 8),
                 (1000, 16, 3, 64), (4096, 16, 8, 256), (5, 7, 0, 1),
                 (1_000_000, 16, 256, 256))


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("case", COMBINE_CASES, ids=str)
def test_combine_bounds_equal_the_reference(case, itemsize):
    n_rows, rank, s, br = case
    for fn in ("phi_combine_wire_bound", "phi_reduce_scatter_wire_bound"):
        assert getattr(P, fn)(n_rows, rank, s, br, itemsize) == \
            getattr(R, fn)(n_rows, rank, s, br, itemsize), fn
    assert P.phi_combine_wire_bound(n_rows, rank, s) == \
        R.phi_combine_wire_bound(n_rows, rank, s)
    assert P.mttkrp_comm_lower_bound(n_rows, rank, s, itemsize) == \
        R.mttkrp_comm_lower_bound(n_rows, rank, s, itemsize)
    for sub, b in itertools.product((0, 1, 24, 512), (0, 1, 2, 4, 16)):
        assert P.grid_combine_wire_bound(sub, rank, b, itemsize) == \
            R.grid_combine_wire_bound(sub, rank, b, itemsize)


@pytest.mark.parametrize("idx_itemsize", (4, 8))
@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_pi_bounds_equal_the_reference(itemsize, idx_itemsize):
    for slot, touched, rank, n_modes in ((0, 0, 1, 2), (640, 96, 4, 3),
                                         (65536, 4000, 16, 4)):
        assert P.pi_gather_wire_bound(slot, touched, rank, n_modes,
                                      itemsize, idx_itemsize) == \
            R.pi_gather_wire_bound(slot, touched, rank, n_modes, itemsize,
                                   idx_itemsize)
    for shape in ((64, 120, 100), (183, 24, 1140, 1717), (1, 1)):
        for mode in range(len(shape)):
            assert P.pi_replicated_gather_bytes(shape, mode, 16, itemsize) \
                == R.pi_replicated_gather_bytes(shape, mode, 16, itemsize)


# (k, i, j, rank): tile-aligned, ragged, unit, the near-dense cap's modes
DENSE_CASES = ((3, 14, 10, 4), (8, 8, 128, 128), (1, 1, 1, 1), (0, 5, 3, 2),
               (128, 256, 128, 16), (32768, 128, 128, 16), (12, 17, 130, 129))


@pytest.mark.parametrize("block_k", (None, 1, 4, 16))
@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("case", DENSE_CASES, ids=str)
def test_dense_counts_equal_the_reference(case, itemsize, block_k):
    k, i, j, r = case
    assert P.dense_pad_dims(k, i, j, r, itemsize, block_k) == \
        R.dense_pad_dims(k, i, j, r, itemsize, block_k)
    assert P.dense_mttkrp_flops(k, i, j, r) == R.dense_mttkrp_flops(k, i, j, r)
    for with_b, padded in itertools.product((False, True), repeat=2):
        assert P.dense_input_bytes(k, i, j, r, itemsize, with_b, padded,
                                   block_k) == \
            R.dense_input_bytes(k, i, j, r, itemsize, with_b, padded,
                                block_k), (with_b, padded)


@PROPERTY
@given(n_rows=ints(0, 10**6), rank=ints(1, 256), s=ints(0, 512),
       br=ints(1, 1024), itemsize=st.sampled_from(ITEMSIZES))
def test_phi_combine_wire_bound_property(n_rows, rank, s, br, itemsize):
    """Equal to the reference; never below the psum of the padded mode
    itself (``buf_rows >= n_rows_pad``)."""
    got = P.phi_combine_wire_bound(n_rows, rank, s, br, itemsize)
    assert got == R.phi_combine_wire_bound(n_rows, rank, s, br, itemsize)
    n_rows_pad = -(-max(n_rows, br) // br) * br
    assert got >= P.allreduce_wire_bytes(n_rows_pad * rank * itemsize, s)


@PROPERTY
@given(n_rows=ints(0, 10**6), rank=ints(1, 256), s=ints(0, 512),
       br=ints(1, 1024), itemsize=st.sampled_from(ITEMSIZES))
def test_phi_reduce_scatter_wire_bound_property(n_rows, rank, s, br,
                                                itemsize):
    """Equal to the reference; half the psum bound (its docstring)."""
    got = P.phi_reduce_scatter_wire_bound(n_rows, rank, s, br, itemsize)
    assert got == R.phi_reduce_scatter_wire_bound(n_rows, rank, s, br,
                                                  itemsize)
    half = P.phi_combine_wire_bound(n_rows, rank, s, br, itemsize) / 2
    assert got == pytest.approx(half, rel=1e-12)


@PROPERTY
@given(n_rows=ints(0, 10**7), rank=ints(1, 256), p=ints(0, 4096),
       itemsize=st.sampled_from(ITEMSIZES))
def test_mttkrp_comm_lower_bound_property(n_rows, rank, p, itemsize):
    """Equal to the reference; a device's 1/P share of the factor panel,
    so P of them hold the whole panel."""
    got = P.mttkrp_comm_lower_bound(n_rows, rank, p, itemsize)
    assert got == R.mttkrp_comm_lower_bound(n_rows, rank, p, itemsize)
    if p > 1:
        assert got * p == pytest.approx(n_rows * rank * itemsize, rel=1e-12)


@PROPERTY
@given(n_rows=ints(1, 10**6), a=ints(1, 64), b=ints(1, 64),
       rank=ints(1, 256), itemsize=st.sampled_from(ITEMSIZES))
def test_grid_combine_wire_bound_property(n_rows, a, b, rank, itemsize):
    """Equal to the reference; at a sub-block that tiles the mode
    (``A * B * sub_rows >= n_rows``) and B >= 2 it is at or above the
    Ballard/Knight/Rouse bound of the A*B devices; zero at B = 1."""
    sub = -(-n_rows // (a * b))
    got = P.grid_combine_wire_bound(sub, rank, b, itemsize)
    assert got == R.grid_combine_wire_bound(sub, rank, b, itemsize)
    if b == 1:
        assert got == 0.0
    else:
        assert got >= P.mttkrp_comm_lower_bound(n_rows, rank, a * b,
                                                itemsize)


@PROPERTY
@given(slot=ints(0, 10**7), touched=ints(0, 10**6), rank=ints(1, 256),
       n_modes=ints(2, 6), itemsize=st.sampled_from(ITEMSIZES),
       idx_itemsize=st.sampled_from((4, 8)))
def test_pi_gather_wire_bound_property(slot, touched, rank, n_modes,
                                       itemsize, idx_itemsize):
    """Equal to the reference; the touched rows' term is the gathered
    factor bytes, the rest grows with the slots alone."""
    got = P.pi_gather_wire_bound(slot, touched, rank, n_modes, itemsize,
                                 idx_itemsize)
    assert got == R.pi_gather_wire_bound(slot, touched, rank, n_modes,
                                         itemsize, idx_itemsize)
    assert got - P.pi_gather_wire_bound(slot, 0, rank, n_modes, itemsize,
                                        idx_itemsize) \
        == touched * rank * itemsize


@PROPERTY
@given(k=ints(0, 4096), i=ints(1, 4096), j=ints(1, 4096), rank=ints(1, 256),
       itemsize=st.sampled_from(ITEMSIZES),
       block_k=st.one_of(st.none(), ints(1, 64)))
def test_dense_input_bytes_property(k, i, j, rank, itemsize, block_k):
    """Equal to the reference in all four forms; the padded count is never
    below the raw one, and ``with_b`` adds exactly the (I, R) block."""
    for with_b, padded in itertools.product((False, True), repeat=2):
        assert P.dense_input_bytes(k, i, j, rank, itemsize, with_b, padded,
                                   block_k) == \
            R.dense_input_bytes(k, i, j, rank, itemsize, with_b, padded,
                                block_k)
    raw = P.dense_input_bytes(k, i, j, rank, itemsize)
    assert P.dense_input_bytes(k, i, j, rank, itemsize, padded=True,
                               block_k=block_k) >= raw
    assert P.dense_input_bytes(k, i, j, rank, itemsize, with_b=True) - raw \
        == i * rank * itemsize


def test_padded_bound_dominates_raw():
    """``tests/test_dense_tier.py``'s pad and FLOP relations on the
    port's functions: padding never lowers the bytes or the FLOPs, is a
    no-op on tile-aligned dims, and bf16 halves the bytes."""
    for (k, i, j, r) in [(3, 14, 10, 4), (8, 8, 128, 128), (1, 1, 1, 1)]:
        raw = P.dense_input_bytes(k, i, j, r)
        assert P.dense_input_bytes(k, i, j, r, padded=True) >= raw
        kp, ip, jp, rp = P.dense_pad_dims(k, i, j, r)
        assert P.dense_mttkrp_flops(kp, ip, jp, rp) >= \
            P.dense_mttkrp_flops(k, i, j, r)
    assert P.dense_input_bytes(8, 8, 128, 128, padded=True) == \
        P.dense_input_bytes(8, 8, 128, 128)
    assert P.dense_input_bytes(8, 16, 128, 128, itemsize=2) == \
        P.dense_input_bytes(8, 16, 128, 128) / 2


# ---------------------------------------------------------------------------
# shape_bytes and collective_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("type_str", (
    "f32[4,8]", "(f32[2], bf16[3,3])", "pred[7]", "f32[]", "s4[5]",
    "(s32[2,2], u8[3], f64[1,1,2], token[])", "c128[2]", "f8e4m3fn[16]"))
def test_shape_bytes_equals_the_reference(type_str):
    assert P.shape_bytes(type_str) == R.shape_bytes(type_str)


def test_shape_bytes_tuples():
    """``tests/test_properties.py``'s cases."""
    assert P.shape_bytes("f32[4,8]") == 128
    assert P.shape_bytes("(f32[2], bf16[3,3])") == 8 + 18
    assert P.shape_bytes("pred[7]") == 7


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float64, torch.int64, torch.int32,
                                   torch.bool, torch.float16))
@pytest.mark.parametrize("shape", ((), (7,), (4096, 16), (3, 0, 5)))
def test_type_string_reads_back_the_tensors_bytes(shape, dtype):
    t = torch.zeros(shape, dtype=dtype)
    assert P.shape_bytes(P.type_string(t)) == t.numel() * t.element_size()
    c = P.Collective("all-reduce", 2, P.type_string(t), "data")
    assert (c.bytes, c.itemsize) == (t.numel() * t.element_size(),
                                     t.element_size())


# (kind, group size, result type); each op becomes a log entry and an HLO line
OPS = (("all-reduce", 16, "f32[1024]"), ("all-gather", 4, "bf16[64,64]"),
       ("reduce-scatter", 2, "f32[300,4]"), ("all-reduce", 1, "f32[]"),
       ("all-to-all", 8, "f32[8,128]"), ("collective-permute", 2, "s32[9]"),
       ("reduce-scatter", 4, "bf16[12,16]"), ("all-gather", 2, "f32[24,4]"))


def _hlo(ops, iota: bool) -> str:
    lines = ["HloModule m", "", "ENTRY %main {"]
    for n, (kind, g, ty) in enumerate(ops):
        groups = f"replica_groups=[{64 // max(g, 1)},{g}]<=[64]" if iota \
            else "replica_groups={{" + ",".join(map(str, range(g))) + "}}"
        if kind == "all-gather" and n % 2:  # an async pair: one op
            lines.append(f"  %s{n} = {ty}{{1,0}} {kind}-start(%x), {groups}")
            lines.append(f"  %d{n} = {ty}{{1,0}} {kind}-done(%s{n})")
        else:
            lines.append(f"  %c{n} = {ty}{{0}} {kind}(%x), {groups}, "
                         "to_apply=%add")
    return "\n".join(lines + ["}"])


def _same_stats(got: P.CollectiveStats, want) -> None:
    assert got.by_kind_bytes == want.by_kind_bytes
    assert got.by_kind_count == want.by_kind_count
    assert got.by_kind_wire == want.by_kind_wire
    assert got.wire_bytes == want.wire_bytes
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("iota", (False, True), ids=("explicit", "iota"))
def test_collective_stats_equals_the_reference_on_the_same_ops(iota):
    log = [P.Collective(kind, g, ty, "data") for kind, g, ty in OPS]
    want = R.collective_stats(_hlo(OPS, iota))
    assert sum(want.by_kind_count.values()) == len(OPS)
    _same_stats(P.collective_stats(log), want)


@pytest.mark.parametrize("n", (0, 1, 4))
def test_collective_stats_fallback_ring_size(n):
    """An entry without a group size takes ``n_participants``, as an HLO
    line without ``replica_groups`` does; 0 leaves its bytes unscaled."""
    ops = (("all-reduce", "f32[256,4]"), ("reduce-scatter", "bf16[64]"))
    log = [P.Collective(kind, 0, ty, "world") for kind, ty in ops]
    hlo = "\n".join(f"  %c{i} = {ty} {kind}(%x), to_apply=%add"
                    for i, (kind, ty) in enumerate(ops))
    _same_stats(P.collective_stats(log, n_participants=n),
                R.collective_stats(hlo, n_participants=n))


# ---------------------------------------------------------------------------
# The recorder and the per-rank operand bytes
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def one_rank_gloo():
    from repro_torch.launch.train import process_group

    with process_group(torch.device("cpu")):
        yield P_dist.make_phi_mesh(1, "cpu")


def test_recorder_logs_the_sharded_collectives_on_one_rank():
    """A one-rank gloo group: the fused owner step records one
    reduce-scatter of the owned slice and one scalar KKT max, the psum Φ
    one all-reduce of the combine buffer, the reassembling owner Φ its
    all-gather; each result's bytes are the model's buffer bytes and the
    wire is 0 at one rank.  Nothing is recorded outside the block, and
    nested blocks each keep their own log."""
    t, kt = make_fixture("uniform")
    t = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                 np.asarray(t.values), device="cpu")
    kt = ktensor_from_numpy(np.asarray(kt.lam),
                            [np.asarray(f) for f in kt.factors], "cpu")
    mv = sort_mode(t, 0)
    sl = shard_blocked_layout(
        build_blocked_layout(mv.rows.numpy(), mv.n_rows, BN, BR), 1)
    opart = owner_partition(sl)
    pi = pi_rows(mv.sorted_idx, kt.factors, 0)
    vals_es, pi_es = expand_to_shards(sl, mv.sorted_vals, pi)
    b = kt.factors[0] * kt.lam[None, :]
    assert P_dist._recorder is None
    with one_rank_gloo() as mesh:
        with P.record_collectives() as outer:
            P_dist.phi_mu_sharded_owner(
                sl, opart, vals_es, pi_es,
                P_dist.owner_stack(opart, b, mesh), mesh=mesh)
            with P.record_collectives() as inner:
                P_dist.phi_sharded(sl, vals_es, pi_es, b, mesh=mesh)
            P_dist.phi_sharded(sl, vals_es, pi_es, b, mesh=mesh,
                               combine="reduce_scatter")
        P_dist.phi_sharded(sl, vals_es, pi_es, b, mesh=mesh)
    assert P_dist._recorder is None
    own, buf = opart.scatter_bytes(RANK), P_dist.sharded_combine_bytes(sl,
                                                                       RANK)
    assert [(c.kind, c.group_size, c.tag, c.bytes) for c in outer] == [
        ("reduce-scatter", 1, "data", own), ("all-reduce", 1, "data", 4.0),
        ("reduce-scatter", 1, "data", own),
        ("all-gather", 1, "data", own)]
    assert [(c.kind, c.bytes, c.type) for c in inner] == [
        ("all-reduce", buf, f"f32[{sl.buf_rows},{RANK}]")]
    assert P.collective_stats(outer + inner).wire_bytes == 0.0


def test_recorder_swallows_no_error():
    """A collective that raises propagates its error and leaves no entry;
    the recorder is unset after the block."""
    with one_rank_gloo() as mesh:
        group = mesh.get_group(0)
        with pytest.raises((RuntimeError, ValueError)):
            with P.record_collectives() as log:
                P_dist._reduce_scatter(torch.zeros(3), torch.zeros(5), group,
                                       tag="data")
        assert log == []
        with pytest.raises(KeyError):
            with P.record_collectives():
                raise KeyError("inside the block")
    assert P_dist._recorder is None


def test_entry_parameter_bytes_counts_the_local_shard():
    """A plain tensor counts whole, a DTensor its local shard (a fake
    group of 4 ranks, as the dry run's)."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg as fake_pg
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    assert P.entry_parameter_bytes([torch.zeros(3, 5),
                                    torch.zeros(7, dtype=torch.int64),
                                    torch.zeros((), dtype=torch.bool)]) == \
        [60.0, 56.0, 1.0]
    if dist.is_initialized():  # pragma: no cover - a stray group
        pytest.skip("a process group is already initialized here")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,))
        d = DTensor.from_local(torch.zeros(3, 5), mesh, [Shard(0)])
        assert tuple(d.shape) == (12, 5)
        assert P.entry_parameter_bytes([d, torch.zeros(2)]) == [60.0, 8.0]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The dense wrappers' operands
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def near_dense():
    """``tests/test_dense_tier.py``'s near-dense 4-way tensor (fill ~0.5),
    built by the JAX package and handed over as numpy."""
    t, kt = random_poisson_tensor(jax.random.PRNGKey(2), (14, 10, 6, 4),
                                  nnz=1700, rank=RANK)
    return (tuple(t.shape), np.asarray(t.indices), np.asarray(t.values),
            [torch.tensor(np.asarray(f)) for f in kt.factors],
            torch.tensor(np.asarray(kt.lam)))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("mode", (0, 1, 2, 3))
def test_dense_wrappers_hand_their_kernel_dense_input_bytes(near_dense,
                                                            monkeypatch,
                                                            mode, dtype):
    """What each dense wrapper hands its kernel's plain version is
    ``dense_input_bytes(K, I, J, R, itemsize)`` exactly: ``x``, ``c``,
    ``a`` (and ``b`` for Φ and the fused step, ``with_b=True``), unpadded."""
    shape, idx, vals, factors, lam = near_dense
    seen: dict = {}
    for name in ("mttkrp_dense_ref", "phi_dense_ref", "phi_mu_dense_ref"):
        def spy(*args, _name=name, _fn=getattr(dense_ref, name)):
            seen[_name] = P.entry_parameter_bytes(
                [a for a in args if isinstance(a, torch.Tensor)])
            return _fn(*args)

        monkeypatch.setattr(dense_ref, name, spy)
    dn = build_dense_mode(idx, vals, shape, mode, device="cpu")
    facs = [f.to(dtype) for f in factors]
    b = (factors[mode] * lam[None, :]).to(dtype)
    x, c, a = _dense_operands(dn, facs, b)
    k, i, j = x.shape
    dense_ops.mttkrp_dense(x, c, a)
    dense_ops.phi_dense(x, c, a, b)
    dense_ops.phi_mu_dense(x, c, a, b)
    isz = x.element_size()
    assert isz == (2 if dtype == torch.bfloat16 else 4)
    assert sum(seen["mttkrp_dense_ref"]) == P.dense_input_bytes(
        k, i, j, RANK, isz) == R.dense_input_bytes(k, i, j, RANK, isz)
    for name in ("phi_dense_ref", "phi_mu_dense_ref"):
        assert sum(seen[name]) == P.dense_input_bytes(
            k, i, j, RANK, isz, with_b=True), name
    assert P.dense_input_bytes(k, i, j, RANK, isz, padded=True) > \
        sum(seen["mttkrp_dense_ref"])  # the TPU's tiles pad, the port not
