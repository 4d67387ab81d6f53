"""The port's training infrastructure, mirroring the JAX package's
``tests/test_train_infra.py``: checkpoint round trip, exact resume, the
retention window, the straggler watchdog and pipeline determinism; plus
the port's batches equal to the reference's bit for bit, checkpoints
across the two packages both ways, and the ``launch.train`` driver on
the CPU (with its resume).  Everything runs on ``device="cpu"``; asked
for the card without one, every entry point raises.
"""
import contextlib
import dataclasses
import io
import os
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.config import ShapeConfig as RShape
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models.api import build_model as r_build_model
from repro.train import checkpoint as R_ckpt
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.step import init_state as r_init_state

from repro_torch import configs as P_configs
from repro_torch.config import ShapeConfig as PShape
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as P_launch
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import abstract_params, tree_leaves, tree_map
from repro_torch.train import checkpoint as P_ckpt
from repro_torch.train.checkpoint import Checkpointer, latest_step
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import init_state, make_train_step, state_specs

CFG = P_configs.reduced(P_configs.ARCHS["olmo-1b"])
SHAPE = PShape("t", 32, 4, "train")
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp, total=8, every=4, opt_name="adamw"):
    model = build_model(CFG)
    opt = make_optimizer(opt_name, lr=1e-3)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(CFG, SHAPE, seed=7, device=CPU)
    loop = TrainLoop(step, pipe.make_batch,
                     TrainLoopConfig(total_steps=total, ckpt_every=every,
                                     ckpt_dir=tmp), device=CPU)
    return model, opt, loop


def _equal_trees(a, b, where=""):
    """Same keys; every leaf of the same dtype and bitwise equal."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            _equal_trees(a[k], b[k], f"{where}/{k}")
        return
    assert a.dtype == b.dtype and torch.equal(a, b), where


def test_checkpoint_roundtrip(tmp_path):
    model = build_model(CFG)
    opt = make_optimizer("adamw")
    state = init_state(model, opt, 0, device=CPU)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    assert ck.latest_step() == 3
    target = abstract_params(state_specs(model, opt))
    assert all(t.device.type == "meta" for t in tree_leaves(target))
    restored, step = ck.restore(target, device=CPU)
    assert step == 3
    _equal_trees(state, restored)


def test_resume_is_exact(tmp_path):
    """run 8 steps straight == run 4, 'crash', resume, run 4 more."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    model, opt, loop1 = _setup(d1, total=8, every=4)
    init_fn = lambda: init_state(model, opt, 1, device=CPU)
    s1, _ = loop1.resume_or_init(init_fn)
    s1, _ = loop1.run(s1, 0)

    model, opt, loop2 = _setup(d2, total=4, every=4)
    s2, _ = loop2.resume_or_init(init_fn)
    s2, _ = loop2.run(s2, 0)
    # "crash" here; a new loop resumes from step 4
    model, opt, loop3 = _setup(d2, total=8, every=4)
    s3, start = loop3.resume_or_init(
        init_fn, target=abstract_params(state_specs(model, opt)))
    assert start == 4
    s3, end = loop3.run(s3, start)
    assert end == 8 and [r["step"] for r in loop3.history] == [5, 6, 7, 8]
    # the same ops on the same inputs: bitwise, not just close
    _equal_trees(s1, s3)
    assert [r["loss"] for r in loop1.history[4:]] == \
        [r["loss"] for r in loop3.history]


def test_resume_without_a_target_runs_init_once(tmp_path):
    model, opt, loop = _setup(str(tmp_path), total=2, every=2)
    calls = []

    def init_fn():
        calls.append(1)
        return init_state(model, opt, 4, device=CPU)

    s, _ = loop.resume_or_init(init_fn)
    s, _ = loop.run(s, 0)
    _, _, loop2 = _setup(str(tmp_path), total=2, every=2)
    s2, start = loop2.resume_or_init(init_fn)
    assert start == 2 and len(calls) == 2
    _equal_trees(s, s2)


def test_straggler_watchdog_detects_injected_delay(tmp_path):
    model, opt, loop = _setup(str(tmp_path), total=12, every=100)
    inner = loop.train_step
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 10:
            time.sleep(0.6)  # injected straggler
        return inner(state, batch)

    loop.train_step = slow_step
    state, _ = loop.resume_or_init(
        lambda: init_state(model, opt, 2, device=CPU))
    loop.run(state, 0)
    assert any(e["step"] == 10 for e in loop.straggler_events)
    assert all(e["step"] > 5 for e in loop.straggler_events)
    assert len(loop.history) == 12 and loop.ckpt.latest_step() == 12


def test_sigterm_finishes_the_step_and_saves(tmp_path):
    """A SIGTERM during a step: the step completes, is checkpointed, and
    the loop returns; the handlers are restored afterwards."""
    import signal

    model, opt, loop = _setup(str(tmp_path), total=10, every=100)
    inner = loop.train_step

    def step_then_term(state, batch):
        out = inner(state, batch)
        if len(loop.history) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    loop.train_step = step_then_term
    before = signal.getsignal(signal.SIGTERM)
    state, _ = loop.resume_or_init(
        lambda: init_state(model, opt, 3, device=CPU))
    _, end = loop.run(state, 0)
    assert end == 3 and loop.ckpt.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is before
    import json
    with open(os.path.join(str(tmp_path), "LATEST")) as f:
        assert json.load(f)["preempted"] is True


def test_checkpoint_gc_keeps_window(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.ones((3,))}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["step_00000003.npz", "step_00000004.npz"]
    assert ck.latest_step() == 4
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("name", ("olmo-1b", "pixtral-12b", "whisper-medium"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_pipeline_matches_reference_bit_for_bit(name, dtype):
    """Deterministic in (seed, step), and the reference's batches bit for
    bit (bf16 patches and frames too)."""
    rcfg = dataclasses.replace(R_configs.reduced(R_configs.ARCHS[name]),
                               dtype=dtype)
    pcfg = dataclasses.replace(P_configs.reduced(P_configs.ARCHS[name]),
                               dtype=dtype)
    p1 = TokenPipeline(pcfg, SHAPE, seed=3, device=CPU)
    p2 = TokenPipeline(pcfg, SHAPE, seed=3, device=CPU)
    b1, b2 = p1.make_batch(5), p2.make_batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], p1.make_batch(6)["tokens"])
    want = RPipeline(rcfg, RShape("t", 32, 4, "train"), seed=3).make_batch(5)
    assert sorted(b1) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        got = b1[k]
        if w.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert got.numpy().dtype == w.dtype
            np.testing.assert_array_equal(got.numpy(), w)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------


def _ref_state(seed=0):
    rcfg = R_configs.reduced(R_configs.ARCHS["olmo-1b"])
    model = r_build_model(rcfg)
    return r_init_state(model, r_make_optimizer("adamw"),
                        jax.random.PRNGKey(seed))


def test_port_restores_reference_checkpoints(tmp_path):
    rstate = _ref_state()
    R_ckpt.save(str(tmp_path), 5, rstate)
    model, opt = build_model(CFG), make_optimizer("adamw")
    got, step = P_ckpt.restore(str(tmp_path),
                               abstract_params(state_specs(model, opt)),
                               device=CPU)
    assert step == 5 and latest_step(str(tmp_path)) == 5
    _equal_trees(got, params_from_numpy(jax.tree.map(np.asarray, rstate),
                                        CPU))


def test_reference_restores_port_checkpoints(tmp_path):
    model, opt = build_model(CFG), make_optimizer("adamw")
    state = init_state(model, opt, 9, device=CPU)
    P_ckpt.save(str(tmp_path), 7, state)
    target = jax.eval_shape(lambda: _ref_state())
    got, step = R_ckpt.restore(str(tmp_path), target)
    assert step == 7 and R_ckpt.latest_step(str(tmp_path)) == 7
    flat = {}

    def walk(t, pre=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (k,))
        else:
            flat["/".join(pre)] = t

    walk(state)
    leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy())
        assert np.asarray(leaf).dtype == flat[key].numpy().dtype


def test_bf16_leaves_cross_byte_for_byte(tmp_path):
    """A bf16 leaf: the port writes the reference's npy bytes exactly
    (descr ``'<V2'``), and restores the reference's file, which the
    reference's own ``restore`` cannot read back."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(w, jnp.bfloat16), "s": jnp.int32(4),
            "z": {"f": jnp.asarray(w[0])}}
    rdir, pdir = str(tmp_path / "r"), str(tmp_path / "p")
    R_ckpt.save(rdir, 1, tree)
    ptree = params_from_numpy(jax.tree.map(np.asarray, tree), CPU)
    P_ckpt.save(pdir, 1, ptree)
    name = "step_00000001.npz"
    with zipfile.ZipFile(os.path.join(rdir, name)) as zr, \
            zipfile.ZipFile(os.path.join(pdir, name)) as zp:
        assert zr.namelist() == zp.namelist()
        for member in zr.namelist():
            assert zr.read(member) == zp.read(member), member
    target = tree_map(lambda t: t.to("meta"), ptree)
    for d in (rdir, pdir):
        got, _ = P_ckpt.restore(d, target, device=CPU)
        _equal_trees(got, ptree)
    with pytest.raises(TypeError):
        R_ckpt.restore(rdir, jax.eval_shape(lambda: tree))
    with pytest.raises(ValueError, match="bfloat16"):
        P_ckpt.restore(rdir, {"w": torch.empty((6, 5), device="meta"),
                              "s": target["s"], "z": target["z"]}, device=CPU)


def test_restore_checks_shapes_and_leaves(tmp_path):
    P_ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        P_ckpt.restore(str(tmp_path), {"a": torch.empty(4, device="meta")},
                       device=CPU)
    with pytest.raises(KeyError, match="missing leaf"):
        P_ckpt.restore(str(tmp_path), {"b": torch.empty(3, device="meta")},
                       device=CPU)
    with pytest.raises(FileNotFoundError):
        P_ckpt.restore(str(tmp_path / "none"), {}, device=CPU)


# ---------------------------------------------------------------------------
# The driver and the device default
# ---------------------------------------------------------------------------


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "olmo-1b", "--steps", "3", "--ckpt-every", "2",
            "--batch", "2", "--seq", "32", "--ckpt-dir", ck,
            "--device", "cpu", "--compress", "int8"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert P_launch.main(argv) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[train] arch=olmo-1b-smoke ")
    assert "mesh={'data': 1, 'model': 1} start_step=0" in lines[0]
    assert sum(ln.startswith("[train] step") for ln in lines) == 3
    assert lines[-1].startswith("[train] done at step 3")
    assert latest_step(ck) == 3
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert P_launch.main(argv[:3] + ["5"] + argv[4:]) == 0
    lines = out.getvalue().splitlines()
    assert "start_step=3" in lines[0]
    assert [ln.split()[2] for ln in lines
            if ln.startswith("[train] step")] == ["4", "5"]
    assert lines[-1].startswith("[train] done at step 5")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_the_card():
    model, opt = build_model(CFG), make_optimizer("adamw")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(CFG, SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(model, opt, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(make_train_step(model, opt), None, TrainLoopConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_launch.main(["--arch", "olmo-1b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_ckpt.restore("unused", {})
