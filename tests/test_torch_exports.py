"""The port's public surface against the JAX package's.

Package exports: every public name a reference package ``__init__``
gives (its ``__all__`` where it has one, else its public non-module
attributes) is exported by the port's counterpart under the same name and
listed in its ``__all__``, ``repro.perf``'s HLO names included:
``perf/hlo.py``'s counterpart is ``repro_torch/perf/comm.py``, which reads
the port's own collectives and operands where the reference reads XLA's
HLO.
The whole surface: every public function, class and method of every
reference module with a counterpart binds a call written against the
reference as the reference does (one case per qualified name; the rule
is set out above ``RENAMES``).  The differences that stay are named, with
their reasons, in ``DELIBERATE``, and a second test holds each of them
still different.  The new parameters carry their values: a sharded
``mttkrp_mode``
with ``local_strategy="cuda"`` (the MTTKRP kernel's plain version on CPU
tensors) matches the reference's ``local_strategy="pallas"`` at ``TOL``,
and ``mode_key(..., n_shards)`` gives the reference's ``/shards=`` key.
"""
import ast
import functools
import importlib
import inspect
import os
import pathlib
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
# The whole public surface
# ---------------------------------------------------------------------------
#
# The rule, for every public function, class (``__init__`` or dataclass
# fields) and public method of every reference module with a counterpart:
# the reference's parameters come first, in its order, with the same name
# (or a rename of RENAMES, in the same slot) and the same kind; a
# plain-value default keeps its value (strategy names read through the
# port's alias ``pallas`` -> ``cuda``); a parameter with a default keeps
# one.  The port's own parameters come after them, each with a default.
# Public constants and properties exist under the same name.

# documented renames: a PRNG key becomes an int seed, JAX's device list
# the mesh's device type, the TPU kernel switch the CUDA one
RENAMES = {"key": "seed", "keys": "seeds", "devices": "device_type",
           "include_pallas": "include_cuda"}
MODULE_MAP = {"repro.perf.hlo": "repro_torch.perf.comm"}
# reference modules the port has no counterpart of, and why
NO_COUNTERPART = {
    "repro.perf.hlo_costs": "parses the optimized HLO of a compiled XLA "
                            "program; the port compiles none (its autotuner "
                            "scores from analytic counts, its dry run counts "
                            "with FlopCounterMode and MemTracker)",
}
# the Pallas builders' counterparts: the CUDA launches of the same module
KERNEL_BUILDERS = {
    "kernels.phi.kernel::phi_pallas_call": "launch_phi",
    "kernels.phi.kernel::phi_mu_pallas_call": "launch_phi_mu",
    "kernels.mttkrp.kernel::mttkrp_pallas_call": "launch_mttkrp",
    "kernels.dense.kernel::dense_mttkrp_pallas_call": "launch_mttkrp",
    "kernels.dense.kernel::dense_phi_pallas_call": "launch_phi",
    "kernels.dense.kernel::dense_phi_mu_pallas_call": "launch_phi_mu",
    "kernels.stream.kernel::stream_pallas_call": "launch_stream",
}
_PYTREE = ("a JAX pytree hook; the port's containers hold tensors and are "
           "not pytrees")
_TILE = "a TPU tile size of the Pallas kernel; the CUDA kernels tile otherwise"
_HLO = ("reads XLA's HLO text; the port has none and reads its own recorded "
        "collectives and operands")
# every difference that stays, with its reason; nothing else is excused
DELIBERATE = {
    "launch.dryrun::analyze": "takes XLA's lowered and compiled programs; "
                              "the port analyzes its step function under "
                              "FakeTensorMode instead",
    "core.sparse_tensor::SparseTensor.tree_flatten": _PYTREE,
    "core.sparse_tensor::SparseTensor.tree_unflatten": _PYTREE,
    "core.sparse_tensor::ModeView.tree_flatten": _PYTREE,
    "core.sparse_tensor::ModeView.tree_unflatten": _PYTREE,
    "core.sparse_tensor::KTensor.tree_flatten": _PYTREE,
    "core.sparse_tensor::KTensor.tree_unflatten": _PYTREE,
    "core.resilience::XLA_ERRORS": "XLA's runtime exception types; the port "
                                   "classifies CUDA's failures instead",
    "kernels.phi.kernel::KKT_TILE": _TILE,
    "kernels.dense.kernel::KKT_TILE": _TILE,
    "perf.hlo::collective_stats": _HLO,
    "perf.hlo::entry_parameter_bytes": _HLO,
    "core.cpapr::CPAPRConfig": "max_demotions defaults to 0 (the reference: "
                               "4): on the card a kernel that fails is an "
                               "error unless the caller turns the ladder on",
    "perf.roofline::RooflineTerms": "peak_flops defaults to the H100's; the "
                                    "reference's default is a TPU's peak",
    "testing.faults::fail_strategy": "the simulated failure's default message "
                                     "names a CUDA launch (the reference's: "
                                     "Mosaic lowering); both classify as a "
                                     "kernel failure",
    "train.loop::TrainLoopConfig": "ckpt_dir defaults under the temp "
                                   "directory and is named for the port, so "
                                   "a run never resumes from the reference's "
                                   "checkpoints, which share its format",
}
# the port's own parameters, pinned for the entry points that had to move
OWN = {
    "core.cpals::mttkrp": ["device"],
    "core.cpals::mttkrp_mode": ["device"],
    "core.phi::phi_from_rows": ["device"],
    "core.phi::phi_mu_step": ["device"],
    "core.phi::krao_reduce_rows": ["device"],
    "core.cpapr::resolve_mode_policies": ["shape", "device"],
    "core.cpapr::CPAPRResult": ["sweep_seconds"],
    "core.sparse_tensor::random_ktensor": ["device"],
    "core.sparse_tensor::random_poisson_tensor": ["device"],
    "perf.autotune::Autotuner.mode_key": [],
    "perf.autotune::candidate_policies": ["include_pallas"],
    "perf.autotune::Autotuner": ["include_pallas"],
    "perf.roofline::HardwareSpec": [],
    "train.checkpoint::restore": ["device"],
    "train.checkpoint::Checkpointer.restore": ["device"],
    "train.loop::TrainLoop": ["device"],
    "data.pipeline::TokenPipeline": ["device"],
    "launch.dryrun::lower_cell": [],
    "kernels.phi.ops::phi_blocked_arrays": [],
    "kernels.phi.ops::phi_blocked": [],
    "kernels.phi.ops::phi_mu_blocked": [],
    "kernels.mttkrp.ops::mttkrp_blocked_arrays": [],
    "kernels.mttkrp.ops::mttkrp_blocked": [],
    "kernels.dense.ops::mttkrp_dense": [],
    "kernels.dense.ops::phi_dense": [],
    "kernels.dense.ops::phi_mu_dense": [],
    "kernels.stream.ops::stream_op": [],
    "kernels.phi.ref::phi_blocked_ref": [],
    "kernels.mttkrp.ref::mttkrp_blocked_ref": [],
}
_E = inspect.Parameter.empty
_SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _reference_modules() -> dict:
    """{reference module name: source path}, every module of the package."""
    out = {}
    for f in sorted((_SRC / "repro").rglob("*.py")):
        parts = list(f.relative_to(_SRC).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out[".".join(parts)] = f
    return out


def _import_reference(name: str):
    # repro.launch.dryrun forces 512 host devices through XLA_FLAGS on
    # import; keep that from reaching this process's jax backend
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


def _public_names(path) -> list:
    """The public top-level functions, classes and constants a module
    defines (not those it imports), in source order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _surface() -> dict:
    """{qualified name: (reference module, port module name, name,
    method name or None)} over every reference module with a
    counterpart; qualified names read ``core.phi::phi_from_rows`` and
    ``core.dense::DenseModeData.with_x``."""
    out = {}
    for mod, path in _reference_modules().items():
        if mod in NO_COUNTERPART:
            continue
        ref = _import_reference(mod)
        port = MODULE_MAP.get(mod, "repro_torch" + mod[len("repro"):])
        short = mod[len("repro."):]
        for name in _public_names(path):
            obj = getattr(ref, name)
            out[f"{short}::{name}"] = (ref, port, name, None)
            if not inspect.isclass(obj) or obj.__module__ != mod:
                continue
            for meth, m in vars(obj).items():
                if meth.startswith("_"):
                    continue
                if isinstance(m, (staticmethod, classmethod)):
                    m = m.__func__
                if inspect.isfunction(m) or isinstance(m, property):
                    out[f"{short}::{name}.{meth}"] = (ref, port, name, meth)
    return out


SURFACE = _surface()


def _unwrap(m):
    return m.__func__ if isinstance(m, (staticmethod, classmethod)) else m


def _plain(v) -> bool:
    if isinstance(v, tuple):
        return all(_plain(x) for x in v)
    return v is None or isinstance(v, (bool, int, float, str))


def _alias(v):
    return "cuda" if v == "pallas" else v


def signature_faults(ref_fn, port_fn) -> list:
    """Where a call written against ``ref_fn`` binds otherwise in
    ``port_fn``: a list of faults, empty when the rule holds."""
    try:
        rs = inspect.signature(ref_fn)
    except (TypeError, ValueError):  # no Python signature (builtins)
        return []
    ps = inspect.signature(port_fn)
    var_kw = inspect.Parameter.VAR_KEYWORD
    rp = [p for p in rs.parameters.values() if p.kind != var_kw]
    pp = [p for p in ps.parameters.values() if p.kind != var_kw]
    faults = []
    for i, r in enumerate(rp):
        if i >= len(pp):
            return faults + [f"lacks {r.name!r}"]
        p = pp[i]
        if p.name not in (r.name, RENAMES.get(r.name)):
            return faults + [f"slot {i}: the reference has {r.name!r}, the "
                             f"port {p.name!r}"]
        if p.kind != r.kind:
            faults.append(f"{r.name!r} is {r.kind.description} in the "
                          f"reference, {p.kind.description} in the port")
        if r.default is _E:
            continue
        if p.default is _E:
            faults.append(f"{r.name!r} has no default in the port")
        elif (_plain(r.default) and (r.name == p.name or r.default is None)
              and not (_plain(p.default)
                       and _alias(p.default) == _alias(r.default))):
            faults.append(f"{r.name!r} defaults to {r.default!r} in the "
                          f"reference, {p.default!r} in the port")
    faults += [f"the port's own {p.name!r} has no default"
               for p in pp[len(rp):]
               if p.default is _E and p.kind != p.VAR_POSITIONAL]
    if any(p.kind == var_kw for p in rs.parameters.values()) and not any(
            p.kind == var_kw for p in ps.parameters.values()):
        faults.append("lacks the reference's **kwargs")
    return faults


def own_params(ref_fn, port_fn) -> list:
    """The port's parameters after the reference's."""
    n = len([p for p in inspect.signature(ref_fn).parameters.values()
             if p.kind != p.VAR_KEYWORD])
    return [p.name for p in list(inspect.signature(port_fn).parameters
                                 .values())[n:]
            if p.kind != p.VAR_KEYWORD]


def surface_faults(qual: str) -> list:
    ref, port_name, name, meth = SURFACE[qual]
    if qual in KERNEL_BUILDERS:
        port = importlib.import_module(port_name)
        launch = KERNEL_BUILDERS[qual]
        return [] if callable(getattr(port, launch, None)) else [
            f"{port_name} lacks {launch}, the builder's counterpart"]
    try:
        port = importlib.import_module(port_name)
    except ImportError:
        return [f"no module {port_name}"]
    obj = getattr(ref, name)
    if not hasattr(port, name):
        return [f"{port_name} lacks {name}"]
    pobj = getattr(port, name)
    if meth is not None:
        if meth not in dir(pobj):
            return [f"{port_name}.{name} lacks {meth}"]
        r = _unwrap(inspect.getattr_static(obj, meth))
        p = _unwrap(inspect.getattr_static(pobj, meth))
        if isinstance(r, property):
            return [] if isinstance(p, property) else [f"{meth} is not a "
                                                       "property"]
        return signature_faults(r, p)
    if callable(obj) and getattr(obj, "__module__", None) == ref.__name__:
        return signature_faults(obj, pobj)
    return []  # a constant: it exists


def test_every_reference_module_has_a_counterpart():
    mods = _reference_modules()
    assert set(NO_COUNTERPART) <= set(mods)
    for mod in mods:
        port = MODULE_MAP.get(mod, "repro_torch" + mod[len("repro"):])
        if mod in NO_COUNTERPART:
            with pytest.raises(ImportError):
                importlib.import_module(port)
        else:
            importlib.import_module(port)
    assert set(KERNEL_BUILDERS) <= set(SURFACE)
    assert set(DELIBERATE) <= set(SURFACE)
    assert set(OWN) <= set(SURFACE)


@pytest.mark.parametrize("qual", sorted(set(SURFACE) - set(DELIBERATE)))
def test_reference_surface_binds_in_the_port(qual):
    faults = surface_faults(qual)
    assert not faults, f"{qual}: " + "; ".join(faults)
    if qual in OWN:
        ref, port_name, name, meth = SURFACE[qual]
        r, p = getattr(ref, name), getattr(
            importlib.import_module(port_name), name)
        if meth is not None:
            r, p = (_unwrap(inspect.getattr_static(r, meth)),
                    _unwrap(inspect.getattr_static(p, meth)))
        assert own_params(r, p) == OWN[qual], qual


@pytest.mark.parametrize("qual", sorted(DELIBERATE))
def test_deliberate_differences_still_differ(qual):
    """Each entry of the deliberate table still differs from the
    reference, so the table cannot outlive the difference it excuses."""
    assert DELIBERATE[qual]
    assert surface_faults(qual), f"{qual} now binds as the reference's: " \
        "drop it from DELIBERATE"


def test_include_pallas_is_an_alias_of_include_cuda():
    """``include_cuda`` stands in the reference's ``include_pallas`` slot
    (the surface cases), and the reference's name is accepted as an
    alias."""
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
