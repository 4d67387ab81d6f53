"""The port's public surface against the JAX package's.

Package exports: every public name a reference package ``__init__``
gives (its ``__all__`` where it has one, else its public non-module
attributes) is exported by the port's counterpart under the same name and
listed in its ``__all__``, ``repro.perf``'s HLO names included:
``perf/hlo.py``'s counterpart is ``repro_torch/perf/comm.py``, which reads
the port's own collectives and operands where the reference reads XLA's
HLO.
Signatures: the reference's parameters bind in the port, in the same
order, so a call written against one package means the same in the
other.  The new parameters carry their values: a sharded ``mttkrp_mode``
with ``local_strategy="cuda"`` (the MTTKRP kernel's plain version on CPU
tensors) matches the reference's ``local_strategy="pallas"`` at ``TOL``,
and ``mode_key(..., n_shards)`` gives the reference's ``/shards=`` key.
"""
import functools
import inspect
import types

import numpy as np
import pytest

import repro.core as R_core
import repro.perf as R_perf
import repro.testing as R_testing
from repro.core import cpals as R_cpals
from repro.core import layout as R_layout
from repro.core.sparse_tensor import sort_mode as r_sort_mode
from repro.perf import autotune as R_autotune

import repro_torch.core as P_core
import repro_torch.perf as P_perf
import repro_torch.testing as P_testing
from repro_torch.core import cpals as P_cpals
from repro_torch.core import layout as P_layout
from repro_torch.core import phi as P_phi
from repro_torch.core.convert import ktensor_from_numpy, sparse_tensor_from_numpy
from repro_torch.core.sparse_tensor import sort_mode as p_sort_mode
from repro_torch.perf import autotune as P_autotune

from test_conformance import BN, BR, FIXTURES, TOL, make_fixture

HLO_NAMES = {"CollectiveStats", "collective_stats", "shape_bytes"}
PACKAGES = {"core": (R_core, P_core), "perf": (R_perf, P_perf),
            "testing": (R_testing, P_testing)}


def exported(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("pkg", tuple(PACKAGES))
def test_package_exports_cover_the_reference(pkg):
    ref, port = PACKAGES[pkg]
    want = exported(ref)
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    unlisted = sorted(want - set(port.__all__))
    assert not unlisted, f"repro_torch.{pkg}.__all__ lacks {unlisted}"


def test_only_the_hlo_names_are_left_out():
    """No name is left out any more: ``repro.perf``'s HLO names and every
    name of ``repro.perf.hlo.__all__`` are exported by ``repro_torch.perf``
    from ``perf/comm.py``, under the same names."""
    from repro.perf import hlo as R_hlo
    from repro_torch.perf import comm as P_comm

    assert HLO_NAMES <= exported(R_perf)
    for name in sorted(HLO_NAMES | set(R_hlo.__all__)):
        assert getattr(P_perf, name) is getattr(P_comm, name), name
        assert name in P_perf.__all__, name


def test_testing_exports_the_fault_harness():
    from repro_torch.testing import faults

    assert P_testing.faults is faults
    assert P_testing.__all__ == R_testing.__all__ == ["faults"]


def test_strategy_tuples_match_the_reference():
    cuda = {"pallas": "cuda"}
    assert P_core.PHI_STRATEGIES == tuple(
        cuda.get(s, s) for s in R_core.PHI_STRATEGIES)
    assert P_core.ALL_PHI_STRATEGIES == tuple(
        cuda.get(s, s) for s in R_core.ALL_PHI_STRATEGIES)
    assert P_core.ALL_PHI_STRATEGIES[-2:] == ("sharded", "grid")
    for s in R_core.ALL_PHI_STRATEGIES:
        assert P_phi.canonical_strategy(s) == cuda.get(s, s)
    with pytest.raises(ValueError, match="unknown strategy"):
        P_phi.canonical_strategy("tpu")


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


def _params(fn) -> list:
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("fn", ("mttkrp", "mttkrp_mode"))
def test_mttkrp_signatures_bind_as_the_reference(fn):
    ref, port = _params(getattr(R_cpals, fn)), _params(getattr(P_cpals, fn))
    assert port[:len(ref)] == ref and port[len(ref):] == ["device"]
    for name in ("mesh", "local_strategy"):
        assert inspect.signature(getattr(P_cpals, fn)).parameters[
            name].default == inspect.signature(getattr(R_cpals, fn)
                                               ).parameters[name].default


def test_autotuner_signatures_bind_as_the_reference():
    assert _params(P_autotune.Autotuner.mode_key) == \
        _params(R_autotune.Autotuner.mode_key)
    # include_cuda stands in the reference's include_pallas slot, and the
    # reference's name is accepted as an alias
    for ref_fn, port_fn in (
            (R_autotune.candidate_policies, P_autotune.candidate_policies),
            (R_autotune.Autotuner.__init__, P_autotune.Autotuner.__init__)):
        ref, port = _params(ref_fn), _params(port_fn)
        i = ref.index("include_pallas")
        assert port[i] == "include_cuda" and "include_pallas" in port
        assert port[:i] == ref[:i]
    a = P_autotune.candidate_policies(10**5, 10**3, 16, "cpu",
                                      include_pallas=True)
    b = P_autotune.candidate_policies(10**5, 10**3, 16, "cpu",
                                      include_cuda=True)
    assert a == b and any(p.strategy == "cuda" for p in a)
    assert P_autotune.Autotuner(measure=False,
                                include_pallas=False).include_cuda is False
    with pytest.raises(ValueError, match="disagree"):
        P_autotune.Autotuner(measure=False, include_cuda=True,
                             include_pallas=False)


@pytest.mark.parametrize("n_shards", (1, 4))
def test_mode_key_with_shards_equals_the_reference(n_shards, tmp_path):
    t, _ = make_fixture("hub")
    rows = np.asarray(r_sort_mode(t, 0).rows)
    want, _ = R_autotune.Autotuner(cache_path=str(tmp_path / "r.json"),
                                   measure=False, platform="cpu").mode_key(
        rows, int(t.shape[0]), 8, n_shards)
    got, _ = P_autotune.Autotuner(cache_path=str(tmp_path / "p.json"),
                                  measure=False, platform="cpu").mode_key(
        rows, int(t.shape[0]), 8, n_shards)
    assert got == want
    assert ("/shards=4" in got) == (n_shards == 4)


# ---------------------------------------------------------------------------
# mttkrp_mode through a sharded layout with a local strategy
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sharded_problem(kind: str, mode: int, n_shards: int):
    t, kt = make_fixture(kind)
    pt = sparse_tensor_from_numpy(t.shape, np.asarray(t.indices),
                                  np.asarray(t.values), device="cpu")
    pkt = ktensor_from_numpy(np.asarray(kt.lam),
                             [np.asarray(f) for f in kt.factors], "cpu")
    rmv, pmv = r_sort_mode(t, mode), p_sort_mode(pt, mode)
    rsl = R_layout.shard_blocked_layout(R_layout.build_blocked_layout(
        np.asarray(rmv.rows), rmv.n_rows, BN, BR), n_shards)
    psl = P_layout.shard_blocked_layout(P_layout.build_blocked_layout(
        pmv.rows.numpy(), pmv.n_rows, BN, BR), n_shards)
    return (rmv, kt, rsl), (pmv, pkt, psl)


@pytest.mark.parametrize("local", ("cuda", "blocked"))
@pytest.mark.parametrize("kind", FIXTURES)
def test_sharded_mttkrp_mode_with_local_strategy(kind, local):
    (rmv, kt, rsl), (pmv, pkt, psl) = _sharded_problem(kind, 1, 2)
    want = R_cpals.mttkrp_mode(rmv, kt.factors, "sharded", rsl, None,
                               {"cuda": "pallas"}.get(local, local))
    got = P_cpals.mttkrp_mode(pmv, pkt.factors, "sharded", psl, None, local,
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = P_cpals.mttkrp_mode(pmv, pkt.factors, "segment", device="cpu")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
