"""LM training on a ``("data", "model")`` DeviceMesh of gloo ranks.

Three spawns through ``repro_torch.testing.dist.run_ranks``:

  1. Four ranks as a 2 x 2 mesh.  Each of the ten reduced f32 archs under
     its own ``sharding_profile`` (and olmo-1b under both) takes one step
     from the JAX package's ``init(PRNGKey(0))`` weights and its
     ``TokenPipeline`` batch (batch 4 x seq 32, so both profiles' batch
     axes divide it), carried across as numpy.  Held against the port's
     single-device step on the same weights and batch (which
     ``test_torch_train.py`` ties to the reference's for every arch) and,
     for olmo-1b and qwen3-moe, against the reference's own jitted
     single-device ``make_train_step``: the loss and grad norm at ``TOL``,
     every parameter and optimizer leaf through ``compare_states`` with
     ``test_torch_train.py``'s treatment of the rounding-sensitive AdamW
     entries and llama4's noise leaf.  olmo-1b's tp_fsdp and zero3 steps
     agree at ``TOL``; no leaf's placements change.  The same spawn runs
     the card's bf16 product ``_MatmulF32`` (a CPU kernel for
     ``aten::mm.dtype`` is registered in the ranks) on DTensors of every
     placement pair on the mesh's 2-rank ``model`` sub-mesh, against the
     f32 product of the same values and its gradient, at ``TOL``.
  2. Two ranks as 1 x 2: the 2 x 2 olmo-1b zero3 state, saved by spawn 1,
     restored onto this mesh (``shardings=``) and onto the CPU with no
     mesh, bitwise.
  3. Two ranks: ``launch.train`` with ``--device cpu --steps 4
     --ckpt-every 2``, then ``--steps 6``, which resumes at step 4.
"""
import numpy as np
import pytest
import torch
import jax

from repro import configs as R_configs
from repro.config import ShapeConfig as RShape
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models.api import build_model as r_build_model
from repro.train import optimizer as R_opt
from repro.train.step import make_train_step as r_make_train_step

from repro_torch import configs as P_configs
from repro_torch.models.api import build_model as p_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import set_rules_profile
from repro_torch.testing.dist import run_ranks
from repro_torch.testing.train_parity import compare_states
from repro_torch.train import optimizer as P_opt
from repro_torch.train.step import make_train_step as p_make_train_step

TOL = dict(rtol=3e-5, atol=1e-5)
SMALL_G_MAX = 8  # as test_torch_train.py
LR = 1e-3
SEQ, BATCH = 32, 4
ARCH_NAMES = sorted(R_configs.ARCHS)
CASES = [(n, R_configs.ARCHS[n].sharding_profile) for n in ARCH_NAMES] + [
    ("olmo-1b", "tp_fsdp")]
SAVED = ("olmo-1b", "zero3")
REF_ARCHS = ("olmo-1b", "qwen3-moe-235b-a22b")
TIMEOUT = 400.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        keys = path.split("/")
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = torch.from_numpy(np.array(v))
    return out


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """Per arch: the reference's weights and batch (numpy), and for
    REF_ARCHS its jitted single-device step's new state and metrics."""
    out = {}
    for name in ARCH_NAMES:
        rcfg = R_configs.reduced(R_configs.ARCHS[name])
        model = r_build_model(rcfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = to_np(RPipeline(rcfg, RShape("t", SEQ, BATCH, "train"),
                                seed=0).make_batch(0))
        rec = {"params": to_np(params), "batch": batch}
        if name in REF_ARCHS:
            opt = R_opt.make_optimizer(rcfg.optimizer, lr=LR)
            state, metrics = jax.jit(r_make_train_step(model, opt))(
                {"params": params, "opt": opt.init(params)}, batch)
            rec["ref_state"], rec["ref_metrics"] = to_np(state), to_np(
                metrics)
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device step of every case (its profile set, as
    the mesh step has it; on one device the rules change nothing)."""
    out = {}
    try:
        for name, profile in CASES:
            set_rules_profile(profile)
            pcfg = P_configs.reduced(P_configs.ARCHS[name])
            opt = P_opt.make_optimizer(pcfg.optimizer, lr=LR)
            params = params_from_numpy(inputs[name]["params"], "cpu")
            batch = {k: torch.from_numpy(v)
                     for k, v in inputs[name]["batch"].items()}
            out[(name, profile)] = p_make_train_step(
                p_build_model(pcfg), opt)(
                {"params": params, "opt": opt.init(params)}, batch)
    finally:
        set_rules_profile("tp_fsdp")
    return out


@pytest.fixture(scope="module")
def mesh_run(inputs, tmp_path_factory):
    """Spawn 1: four gloo ranks, a 2 x 2 mesh."""
    work = tmp_path_factory.mktemp("mesh4")
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    rng = np.random.default_rng(0)
    matmul = [(rng.standard_normal((8, 6, 4)).astype(np.float32),
               rng.standard_normal((4, 10)).astype(np.float32)),
              (rng.standard_normal((2, 6, 4)).astype(np.float32),
               rng.standard_normal((2, 4, 6)).astype(np.float32))]
    cases = [(n, p, inputs[n]["params"], inputs[n]["batch"])
             for n, p in CASES]
    res = run_ranks(4, "mesh_train_checks",
                    (cases, LR, (2, 2), SAVED, ckpt, matmul), str(work),
                    timeout=TIMEOUT)
    return {"ranks": res, "ckpt": ckpt, "matmul": matmul}


def held(got: dict, want: dict, where: str) -> list:
    """``got`` against ``want`` (train states) as ``test_torch_train.py``
    holds the port's against the reference's; returns the noise leaves."""
    r = compare_states(got, want, LR, TOL["rtol"], TOL["atol"])
    assert r["worst"] <= 1.0 and r["sensitive_worst"] <= 1.0, (where, r)
    assert r["n_sensitive_out"] <= SMALL_G_MAX, (where, r)
    return r["noise_leaves"]


@pytest.mark.parametrize("name,profile", CASES)
def test_mesh_step_matches_single_device(mesh_run, single, name, profile):
    got = mesh_run["ranks"][0]["steps"][(name, profile)]
    want_state, want_metrics = single[(name, profile)]
    np.testing.assert_allclose(got["loss"], float(want_metrics["loss"]),
                               **TOL)
    np.testing.assert_allclose(got["grad_norm"],
                               float(want_metrics["grad_norm"]), **TOL)
    assert got["step"] == int(want_metrics["step"]) == 1
    noise = held(unflat(got["state"]), want_state, f"{name}/{profile}")
    # llama4 (top-1 routing) has a router gradient of rounding noise, as
    # in test_torch_train.py
    assert noise == (["blocks/router"] if name.startswith("llama4") else [])


@pytest.mark.parametrize("name", REF_ARCHS)
def test_mesh_step_matches_the_reference(mesh_run, inputs, name):
    profile = R_configs.ARCHS[name].sharding_profile
    got = mesh_run["ranks"][0]["steps"][(name, profile)]
    r = inputs[name]
    np.testing.assert_allclose(got["loss"], float(r["ref_metrics"]["loss"]),
                               **TOL)
    np.testing.assert_allclose(got["grad_norm"],
                               float(r["ref_metrics"]["grad_norm"]), **TOL)
    assert held(unflat(got["state"]), params_from_numpy(r["ref_state"],
                                                        "cpu"), name) == []


def test_zero3_matches_tp_fsdp(mesh_run):
    steps = mesh_run["ranks"][0]["steps"]
    a, b = steps[("olmo-1b", "zero3")], steps[("olmo-1b", "tp_fsdp")]
    np.testing.assert_allclose(a["loss"], b["loss"], **TOL)
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], **TOL)
    assert held(unflat(a["state"]), unflat(b["state"]), "zero3") == []
    # the two profiles lay the weights out differently
    assert a["placements"] != b["placements"]


def test_step_keeps_every_placement(mesh_run):
    for rank, res in enumerate(mesh_run["ranks"]):
        assert sorted(res["moved"]) == sorted(CASES)
        assert all(v == [] for v in res["moved"].values()), (rank, res)


@pytest.mark.parametrize("pair", [0, 1])
def test_matmul_f32_on_dtensors(mesh_run, pair):
    """The bf16 product's DTensor rule: every placement pair gives the
    f32 product of the bf16 values and JAX's transpose-rule gradient."""
    a_np, b_np = mesh_run["matmul"][pair]
    a = torch.from_numpy(a_np).to(torch.bfloat16)
    b = torch.from_numpy(b_np).to(torch.bfloat16)
    y = torch.matmul(a.float(), b.float())
    g = torch.ones_like(y)
    ga = torch.matmul(g, b.float().mT).sum_to_size(a.shape).to(torch.bfloat16)
    if b.dim() == 2:
        gb = torch.matmul(a.reshape(-1, a.shape[-1]).float().T,
                          g.reshape(-1, g.shape[-1]))
    else:
        gb = torch.matmul(a.float().mT, g)
    gb = gb.to(torch.bfloat16)
    res = mesh_run["ranks"][0]["matmul_f32"][pair]
    assert len(res) == 4 * (1 + b.dim())
    for key, (y_d, ga_d, gb_d) in res.items():
        np.testing.assert_allclose(y_d, y.numpy(), err_msg=str(key), **TOL)
        np.testing.assert_allclose(ga_d, ga.float().numpy(),
                                   err_msg=str(key), **TOL)
        np.testing.assert_allclose(gb_d, gb.float().numpy(),
                                   err_msg=str(key), **TOL)


def test_elastic_restore_across_meshes(mesh_run, tmp_path):
    """Spawn 2: the 2 x 2 state restored onto a 1 x 2 mesh and onto the
    CPU, bitwise."""
    res = run_ranks(2, "elastic_restore_checks",
                    (mesh_run["ckpt"], *SAVED, (1, 2)), str(tmp_path),
                    timeout=TIMEOUT)
    saved = mesh_run["ranks"][0]["steps"][SAVED]["state"]
    for r in res:
        assert r["placed"] and r["steps"] == (1, 1)
    for where in ("mesh", "cpu"):
        got = res[0][where]
        assert sorted(got) == sorted(saved)
        for path, want in saved.items():
            assert got[path].dtype == want.dtype, (where, path)
            np.testing.assert_array_equal(got[path], want,
                                          err_msg=f"{where}/{path}")


def test_launcher_trains_and_resumes_on_two_ranks(tmp_path):
    """Spawn 3: the launcher on a 1 x 2 mesh of gloo ranks."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "olmo-1b", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", ck]
    res = run_ranks(2, "launcher_checks",
                    ([argv + ["--steps", "4"], argv + ["--steps", "6"]],),
                    str(tmp_path / "work"), timeout=TIMEOUT)
    (rc1, first), (rc2, second) = res[0]
    assert rc1 == rc2 == 0
    assert first[0].startswith("[train] arch=olmo-1b-smoke ")
    assert "mesh={'data': 1, 'model': 2} start_step=0" in first[0]
    assert [ln.split()[2] for ln in first
            if ln.startswith("[train] step")] == ["1", "2", "3", "4"]
    assert first[-1].startswith("[train] done at step 4")
    assert "start_step=4" in second[0]
    assert [ln.split()[2] for ln in second
            if ln.startswith("[train] step")] == ["5", "6"]
    assert second[-1].startswith("[train] done at step 6")
    assert res[1] == [(0, []), (0, [])]  # only rank 0 prints
