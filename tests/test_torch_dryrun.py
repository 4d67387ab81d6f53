"""The port's dry run (``repro_torch.launch.dryrun``) on two olmo-1b cells
of the single-pod (16 x 16) mesh, as a subprocess on a fake process group
of 256 ranks (``--device cpu``: no card here).

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
from jax.sharding import AbstractMesh

from repro import configs as R_configs
from repro.config import SHAPES as R_SHAPES
from repro.models import params as R_params
from repro.models.api import build_model as r_build_model
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.step import state_specs as r_state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30


def ref_state_bytes(arch: str, shape_name: str) -> int:
    """Per-rank bytes of the cell's state under the reference's specs on
    a (16, 16) mesh: params + optimizer state (train), params + the
    decode cache (decode)."""
    cfg = R_configs.ARCHS[arch]
    shape = R_SHAPES[shape_name]
    model = r_build_model(cfg)
    if shape.kind == "train":
        profile = cfg.sharding_profile
        specs = r_state_specs(model, r_make_optimizer(cfg.optimizer))
    else:
        profile = "tp_fsdp"
        specs = {"params": model.param_specs(),
                 "caches": model.cache_specs(shape.global_batch,
                                             shape.seq_len)}
    mesh = AbstractMesh((16, 16), ("data", "model"))
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


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
def test_dryrun_olmo_cell(shape_name, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", shape_name, "--mesh", "single", "--out",
         str(tmp_path), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=400, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "[dryrun] OK" in out.stdout
    rec = json.load(open(tmp_path / "single" / f"olmo-1b__{shape_name}.json"))
    assert rec["n_chips"] == 256 and rec["mesh"] == "single"
    assert rec["device_type"] == "cpu"
    assert rec["roofline"]["bound_s"] > 0
    assert 0 < rec["hbm_bytes_per_device"] < 80 * GIB
    assert rec["state_bytes_per_device"] == ref_state_bytes("olmo-1b",
                                                            shape_name)
    assert rec["hbm_bytes_per_device"] >= rec["state_bytes_per_device"]
    cfg = R_configs.ARCHS["olmo-1b"]
    shape = R_SHAPES[shape_name]
    n = cfg.n_active_params()
    want = (6.0 * n * shape.tokens if shape.kind == "train"
            else 2.0 * n * shape.global_batch)
    assert rec["roofline"]["model_flops"] == pytest.approx(want, rel=1e-12)
    assert rec["cost"]["flops_all_devices"] == 256 * rec["cost"][
        "flops_per_device"] >= want
    assert rec["collectives"]["wire_bytes"] > 0
    assert "projection" in rec["source"]
    assert "not XLA's" in rec["source"]
