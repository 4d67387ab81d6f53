"""The port's logical-axis rules against the JAX package's, in-process.

The rule functions read only a mesh's axis names and sizes, so the
reference is driven with ``jax.sharding.AbstractMesh`` (no devices) and
the port with a stand-in that has the same ``axis_names`` and
``shape[name]``.  For the state spec tree (parameters and optimizer
state, ``state_specs``) of all ten full configs, under each arch's
``sharding_profile`` (and both profiles for olmo-1b), on the production
meshes (16, 16) and (2, 16, 16) and the small (4, 2), (2, 2) and (1, 1):
``spec_for_axes`` leaf for leaf, ``batch_shardings``' specs on every
shape cell's inputs, and the per-rank state bytes the port's placements
give against those of the reference's specs.
"""
import math
import types

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as R_configs
from repro.config import SHAPES as R_SHAPES
from repro.launch import mesh as R_mesh
from repro.models import params as R_params
from repro.models.api import build_model as r_build_model
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.step import state_specs as r_state_specs

from repro_torch import configs as P_configs
from repro_torch.config import SHAPES as P_SHAPES
from repro_torch.launch import dryrun as P_dryrun
from repro_torch.launch import mesh as P_mesh
from repro_torch.models import params as P_params
from repro_torch.models.api import build_model as p_build_model
from repro_torch.train.optimizer import make_optimizer as p_make_optimizer
from repro_torch.train.step import state_specs as p_state_specs
from torch.distributed.tensor import Replicate, Shard

ARCH_NAMES = sorted(R_configs.ARCHS)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def meshes(key):
    shape, names = MESHES[key]
    ref = AbstractMesh(shape, names)
    port = types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)
    return ref, port


def cases():
    out = []
    for name in ARCH_NAMES:
        profiles = (["tp_fsdp", "zero3"] if name == "olmo-1b"
                    else [R_configs.ARCHS[name].sharding_profile])
        out += [(name, prof) for prof in profiles]
    return out


def norm(entry):
    """A spec entry as None or a tuple of axis names (a PartitionSpec
    writes a one-name tuple as the bare name)."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def ref_spec(spec):
    return tuple(norm(e) for e in spec)


def port_spec(spec, ndim):
    out = tuple(norm(e) for e in spec)
    return out + (None,) * (ndim - len(out))


def spec_trees(name):
    rcfg, pcfg = R_configs.ARCHS[name], P_configs.ARCHS[name]
    rs = r_state_specs(r_build_model(rcfg), r_make_optimizer(rcfg.optimizer))
    ps = p_state_specs(p_build_model(pcfg), p_make_optimizer(pcfg.optimizer))
    return rs, ps


def walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.fixture
def rules():
    """Restore both packages' default rules after a test."""
    yield
    R_params.set_rules_profile("tp_fsdp")
    P_params.set_rules_profile("tp_fsdp")


def test_rule_tables_equal_the_reference():
    assert P_params.DEFAULT_RULES == R_params.DEFAULT_RULES
    assert P_params.ZERO3_RULES == R_params.ZERO3_RULES
    assert sorted(P_params.RULE_PROFILES) == sorted(R_params.RULE_PROFILES)
    for k, v in R_params.RULE_PROFILES.items():
        assert P_params.RULE_PROFILES[k] == v
    assert P_params._AXIS_PRIORITY == R_params._AXIS_PRIORITY


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name,profile", cases())
def test_state_specs_match(name, profile, mesh_key, rules):
    """Every leaf of params + optimizer state: the same mesh axes per dim,
    and the same per-rank bytes."""
    rmesh, pmesh = meshes(mesh_key)
    rules_r = R_params.set_rules_profile(profile)
    rules_p = P_params.set_rules_profile(profile)
    rs, ps = spec_trees(name)
    rl, pl = dict(walk(rs)), dict(walk(ps))
    assert sorted(rl) == sorted(pl)
    sizes = dict(zip(*reversed(MESHES[mesh_key])))
    r_bytes = 0
    for path, r in rl.items():
        p = pl[path]
        assert tuple(p.shape) == tuple(r.shape) and tuple(p.axes) == tuple(
            r.axes), path
        want = ref_spec(R_params.spec_for_axes(r.axes, r.shape, rmesh,
                                               rules_r))
        got = port_spec(P_params.spec_for_axes(p.axes, p.shape, pmesh,
                                               rules_p), len(p.shape))
        assert got == port_spec(want, len(p.shape)), (path, got, want)
        div = math.prod(sizes[a] for e in want if e for a in e)
        r_bytes += math.prod(r.shape) * np.dtype(r.dtype).itemsize // div
    sh = P_mesh.state_shardings(ps, pmesh)
    assert P_dryrun._state_bytes(ps, sh) == r_bytes


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name,profile", cases())
def test_batch_shardings_match(name, profile, mesh_key, rules):
    rmesh, pmesh = meshes(mesh_key)
    R_params.set_rules_profile(profile)
    P_params.set_rules_profile(profile)
    rmodel = r_build_model(R_configs.ARCHS[name])
    pmodel = p_build_model(P_configs.ARCHS[name])
    for shape in R_SHAPES:
        rcfg = R_configs.ARCHS[name]
        if rcfg.n_patches and R_SHAPES[shape].seq_len <= rcfg.n_patches:
            continue
        want = R_mesh.batch_shardings(rmodel.input_specs(R_SHAPES[shape]),
                                      rmesh)
        got = P_mesh.batch_shardings(pmodel.input_specs(P_SHAPES[shape]),
                                     pmesh)
        assert sorted(got) == sorted(want), shape
        for k in want:
            ndim = len(pmodel.input_specs(P_SHAPES[shape])[k][0])
            assert port_spec(got[k].spec, ndim) == port_spec(
                ref_spec(want[k].spec), ndim), (shape, k)


def test_placements_follow_the_spec():
    _, pmesh = meshes("2x16x16")
    assert P_params.placements_for((("pod", "data"), "model", None),
                                   pmesh) == (Shard(0), Shard(0), Shard(1))
    assert P_params.placements_for((None, None), pmesh) == (Replicate(),) * 3
    _, pmesh = meshes("16x16")
    assert P_params.placements_for((None, ("data", "model")), pmesh) == (
        Shard(1), Shard(1))


def test_logical_constraint_without_a_mesh_is_the_identity():
    x = torch.randn(4, 8, 16)
    assert P_params.logical_constraint(x, ("batch", None, None)) is x
    _, pmesh = meshes("2x2")
    with P_params.use_mesh(pmesh):  # a plain tensor is left as it is
        assert P_params.logical_constraint(x, ("batch", None, None)) is x
    assert P_params._ambient_mesh() is None

