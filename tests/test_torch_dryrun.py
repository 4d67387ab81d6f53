"""The port's dry run (``repro_torch.launch.dryrun``) as a subprocess on a
fake process group (``--device cpu``: no card here): two olmo-1b cells of
the single-pod (16 x 16) mesh (256 ranks) and olmo-1b decode_32k on the
multi-pod (2 x 16 x 16) mesh (512 ranks); then two DTensor layouts on a
fake group of 16 that cells of the sweep tripped on (Adafactor's update
clip, the head merge's gradient).

Each record: 256 chips and a positive roofline bound; a per-rank peak
under the card's 80 GiB; per-rank state bytes equal to those of the JAX
package's specs on the same mesh (its rules run on an ``AbstractMesh``);
model FLOPs equal to ``6 N_active tokens`` (train) or ``2 N_active
batch`` (decode) from the reference config's ``n_active_params()``; a
``source`` that calls the numbers a projection and not XLA's.  The
reference's own dry run is not imported here: it sets ``XLA_FLAGS`` when
imported.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as R_configs
from repro.config import SHAPES as R_SHAPES
from repro.models import params as R_params
from repro.models.api import build_model as r_build_model
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.step import state_specs as r_state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def ref_state_bytes(arch: str, shape_name: str, mesh_kind="single") -> int:
    """Per-rank bytes of the cell's state under the reference's specs on
    the production mesh: params + optimizer state (train), params + the
    decode cache (decode), params (prefill)."""
    cfg = R_configs.ARCHS[arch]
    shape = R_SHAPES[shape_name]
    model = r_build_model(cfg)
    if shape.kind == "train":
        profile = cfg.sharding_profile
        specs = r_state_specs(model, r_make_optimizer(cfg.optimizer))
    elif shape.kind == "prefill":
        profile = "tp_fsdp"
        specs = model.param_specs()
    else:
        profile = "tp_fsdp"
        specs = {"params": model.param_specs(),
                 "caches": model.cache_specs(shape.global_batch,
                                             shape.seq_len)}
    mesh = AbstractMesh(*MESHES[mesh_kind])
    rules = R_params.RULE_PROFILES[profile]
    leaves = [s for s in _leaves(specs)]
    total = 0
    for s in leaves:
        spec = R_params.spec_for_axes(s.axes, s.shape, mesh, rules)
        div = math.prod(mesh.shape[a] for e in spec if e
                        for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(s.shape) * np.dtype(s.dtype).itemsize // div
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def run_cell(arch: str, shape_name: str, mesh_kind: str, tmp_path) -> dict:
    """One cell through the CLI; its record, checked as every record is."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", shape_name, "--mesh", mesh_kind, "--out",
         str(tmp_path), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=400, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "[dryrun] OK" in out.stdout
    rec = json.load(open(tmp_path / mesh_kind / f"{arch}__{shape_name}.json"))
    n_chips = math.prod(MESHES[mesh_kind][0])
    assert rec["n_chips"] == n_chips and rec["mesh"] == mesh_kind
    assert rec["device_type"] == "cpu"
    assert rec["roofline"]["bound_s"] > 0
    assert 0 < rec["hbm_bytes_per_device"] < 80 * GIB
    assert rec["state_bytes_per_device"] == ref_state_bytes(
        arch, shape_name, mesh_kind)
    assert rec["hbm_bytes_per_device"] >= rec["state_bytes_per_device"]
    cfg = R_configs.ARCHS[arch]
    shape = R_SHAPES[shape_name]
    n = cfg.n_active_params()
    want = {"train": 6.0 * n * shape.tokens,
            "prefill": 2.0 * n * shape.tokens}.get(
        shape.kind, 2.0 * n * shape.global_batch)
    assert rec["roofline"]["model_flops"] == pytest.approx(want, rel=1e-12)
    assert rec["cost"]["flops_all_devices"] == n_chips * rec["cost"][
        "flops_per_device"] >= want
    assert rec["collectives"]["wire_bytes"] > 0
    assert "projection" in rec["source"]
    assert "not XLA's" in rec["source"]
    return rec


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
def test_dryrun_olmo_cell(shape_name, tmp_path):
    run_cell("olmo-1b", shape_name, "single", tmp_path)


def test_dryrun_multi_pod_cell(tmp_path):
    """olmo-1b decode_32k on 2 x 16 x 16: the pod axis splits the batch
    with the data axis, so the per-rank cache halves against 16 x 16; its
    row of ``table``."""
    from repro_torch.launch.dryrun import table

    rec = run_cell("olmo-1b", "decode_32k", "multi", tmp_path)
    assert rec["state_bytes_per_device"] < ref_state_bytes(
        "olmo-1b", "decode_32k", "single")
    rows = table(str(tmp_path)).splitlines()
    assert len(rows) == 3 and rows[2].startswith(
        "| multi | olmo-1b | decode_32k | "
        f"{rec['state_bytes_per_device'] / GIB:.2f} | ")


def test_adafactor_update_gathers_no_stacked_weight():
    """Adafactor's update clip on a stacked weight whose layer dim splits
    unevenly (94 layers on 16 ranks, as qwen3-moe's experts on the
    single-pod mesh) reduces shard-locally: no all-gather of the weight
    (a mean over that dim made DTensor gather the whole f32 update, 288
    GiB per device in the qwen3-moe train_4k cell)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.train.optimizer import adafactor

    def split(shape):
        local = (-(-shape[0] // 16),) + shape[1:]
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(torch.ones(local), mesh, [Shard(0)],
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    with fake_process_group(16):
        mesh = init_device_mesh("cpu", (16,))
        params = {"w": split((94, 8, 6))}
        state = {"step": torch.zeros((), dtype=torch.int32),
                 "v": {"w": {"v_row": split((94, 8)),
                             "v_col": split((94, 6))}}}
        with CommDebugMode() as comm:
            adafactor().update(params, state, params)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert not any("all_gather" in k for k in counts), counts


@pytest.mark.parametrize("heads", (40, 32))
def test_merge_heads_gradient_splits_whole_heads(heads):
    """The gradient of ``merge_heads`` arrives split on its merged dim (as
    the output projection splits it); it is split into heads only where
    the mesh dim divides them (llama4's 40 heads on 16 ranks: gathered
    first, which torch 2.11's view rules require), and kept split where
    it does (32 heads)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.models.layers import merge_heads

    with fake_process_group(16):
        mesh = init_device_mesh("cpu", (16,))
        x = distribute_tensor(torch.ones(2, 3, heads, 4), mesh,
                              [Replicate()]).requires_grad_()
        y = merge_heads(x)
        assert tuple(y.shape) == (2, 3, heads * 4)
        g = DTensor.from_local(torch.ones(2, 3, heads * 4 // 16), mesh,
                               [Shard(2)], run_check=False,
                               shape=y.shape, stride=y.stride())
        (gx,) = torch.autograd.grad(y, x, g)
    assert tuple(gx.shape) == (2, 3, heads, 4)
    assert tuple(gx.placements) == (
        (Replicate(),) if heads % 16 else (Shard(2),))
