"""The port's LM training step against the JAX package's, on the CPU.

For every one of the ten architectures at its ``reduced`` size (f32,
batch 2, seq 32) the JAX package builds the weights (``init(PRNGKey(0))``)
and both packages draw the batch from their ``TokenPipeline`` (equal bit
for bit); the weights go across as numpy arrays through
``repro_torch.models.convert``.  The reference side is jitted.  Held at
``TOL`` (rtol 3e-5, atol 1e-5): the loss and every gradient leaf of
``loss_fn``, and one ``make_train_step`` with the arch's own
``cfg.optimizer`` (AdamW, Adafactor for qwen3 and llama4): every updated
parameter, every optimizer-state leaf, ``grad_norm`` and ``step``.

An AdamW update is ``lr * m_hat / (sqrt(v_hat) + eps)``: where the
gradient's own scale ``sqrt(v_hat)`` is below 1e-6 (the reference's
second moment tells which entries), a rounding difference of the
gradient moves the update by up to ``2 * lr``.  Those entries are held at
atol ``2 * lr``, and the ones that leave ``TOL`` are counted: at most
``SMALL_G_MAX`` per step.  Measured, one step of each AdamW arch: 0 to 4
such entries (of 218-14030 small ones), the worst |diff| 1.73e-4
(h2o-danube-1.8b); every other entry and leaf at ``TOL``.  The loss, the
gradients and the optimizer state are held at ``TOL`` everywhere.

On olmo-1b reduced: AdamW and Adafactor over 3 steps, two microbatches
against the reference's microbatched step, bf16 gradient accumulation
(at ``TOL_BF16``), bf16 and int8 error-feedback compression with the
residual carried, ``clip_by_global_norm``, the factored Adafactor state,
and remat on against off (bitwise, with the checkpointed calls counted).
``matmul_f32``'s backward rule (the card's bf16 branch) is held on the
CPU against JAX's transpose of ``preferred_element_type=f32``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.config import ShapeConfig as RShape
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models.api import build_model as r_build_model
from repro.models.params import count_params as r_count_params
from repro.train import optimizer as R_opt
from repro.train.compression import CompressionConfig as RComp
from repro.train.step import init_state as r_init_state
from repro.train.step import make_prefill as r_make_prefill
from repro.train.step import make_serve_step as r_make_serve_step
from repro.train.step import make_train_step as r_make_train_step

from repro_torch import configs as P_configs
from repro_torch.config import ShapeConfig as PShape
from repro_torch.data.pipeline import TokenPipeline as PPipeline
from repro_torch.models import layers as P_layers
from repro_torch.models.api import build_model as p_build_model
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.params import count_params as p_count_params
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.testing.train_parity import compare_states
from repro_torch.train import optimizer as P_opt
from repro_torch.train.compression import CompressionConfig as PComp
from repro_torch.train.step import _value_and_grad
from repro_torch.train.step import make_prefill as p_make_prefill
from repro_torch.train.step import make_serve_step as p_make_serve_step
from repro_torch.train.step import make_train_step as p_make_train_step
from repro_torch.train.step import state_specs as p_state_specs

TOL = dict(rtol=3e-5, atol=1e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
ARCH_NAMES = sorted(R_configs.ARCHS)
SEQ, BATCH = 32, 2
LR = 1e-3
SMALL_G_MAX = 8  # rounding-sensitive entries allowed outside TOL per step
FLIPS_MAX = 16  # quantizer boundary flips allowed per compressed step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small CPU ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_close(got, want, where="", tol=TOL):
    """Same keys, shapes and dtypes; values at ``tol`` (ints exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_tree_close(got[k], want[k], f"{where}/{k}", tol)
        return
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, err_msg=where, **tol)


def assert_state_close(got, want, where="", tol=TOL, skip=None) -> list:
    """A port train state against the reference's (numpy) through
    ``compare_states``: every entry at ``tol`` but the rounding-sensitive
    parameter entries, held at their update bound, of which at most
    SMALL_G_MAX may leave ``tol`` outside the noise leaves.  Returns the
    noise leaves' paths."""
    r = compare_states(got, params_from_numpy(want, "cpu"), LR, tol["rtol"],
                       tol["atol"], skip=skip)
    assert r["worst"] <= 1.0 and r["sensitive_worst"] <= 1.0, (where, r)
    assert r["n_sensitive_out"] <= SMALL_G_MAX, (where, r)
    return r["noise_leaves"]


def configs(name, **kw):
    return (dataclasses.replace(R_configs.reduced(R_configs.ARCHS[name]), **kw),
            dataclasses.replace(P_configs.reduced(P_configs.ARCHS[name]), **kw))


def batches(rcfg, pcfg, step=0, batch=BATCH, seed=0):
    """The same batch from both pipelines (checked equal)."""
    rb = to_np(RPipeline(rcfg, RShape("t", SEQ, batch, "train"),
                         seed=seed).make_batch(step))
    pb = PPipeline(pcfg, PShape("t", SEQ, batch, "train"), seed=seed,
                   device="cpu").make_batch(step)
    for k in rb:
        np.testing.assert_array_equal(pb[k].numpy(), rb[k])
    return rb, pb


def port_state(popt, params_np, comp=None):
    params = params_from_numpy(params_np, "cpu")
    state = {"params": params, "opt": popt.init(params)}
    if comp is not None and comp.kind != "none":
        state["resid"] = tree_map(torch.zeros_like, params)
    return state


def _ref_run(name):
    """The reference's weights, batch, loss, gradients and one train step
    of one reduced arch, as numpy."""
    rcfg, pcfg = configs(name)
    model = r_build_model(rcfg)
    params = model.init(jax.random.PRNGKey(0))
    rb, pb = batches(rcfg, pcfg)
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, rb)
    opt = R_opt.make_optimizer(rcfg.optimizer, lr=LR)
    state, metrics = jax.jit(r_make_train_step(model, opt))(
        {"params": params, "opt": opt.init(params)}, rb)
    return {"params": to_np(params), "batch": pb, "loss": np.asarray(loss),
            "grads": to_np(grads), "state": to_np(state),
            "metrics": to_np(metrics)}


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _ref_run(name)
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# All ten architectures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_gradients_match(ref, name):
    r = ref(name)
    _, pcfg = configs(name)
    params = params_from_numpy(r["params"], "cpu")
    loss, grads = _value_and_grad(p_build_model(pcfg), params, r["batch"])
    np.testing.assert_allclose(float(loss), float(r["loss"]), **TOL)
    assert_tree_close(grads, r["grads"], name)
    assert all(not p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_matches(ref, name):
    r = ref(name)
    _, pcfg = configs(name)
    popt = P_opt.make_optimizer(pcfg.optimizer, lr=LR)
    state0 = port_state(popt, r["params"])
    before = tree_map(torch.clone, state0)
    state, metrics = p_make_train_step(p_build_model(pcfg), popt)(
        state0, r["batch"])
    noise = assert_state_close(state, r["state"], name)
    # top-1 routing renormalizes its one gate to exactly 1, so the router
    # of llama4 (top_k 1) has a gradient of rounding noise (|g| < 4e-9
    # in both packages, held at TOL above); Adafactor scales that noise to
    # its clipped update size.  Every other leaf has a real gradient.
    assert noise == (["blocks/router"] if pcfg.top_k == 1 else [])
    assert_tree_close(metrics, r["metrics"], name)
    assert metrics["step"].dtype == torch.int32 and metrics["step"].dim() == 0
    # functional: the state it was given is left as it was
    for a, b in zip(tree_leaves(state0), tree_leaves(before)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_changes_no_number(name, monkeypatch):
    """Remat on against off, bitwise: loss and every gradient; the
    checkpointed calls of one forward are the layer stacks' bodies plus
    the CE chunk."""
    _, pcfg = configs(name)
    model_off = p_build_model(pcfg)
    model_on = p_build_model(dataclasses.replace(pcfg, remat=True))
    params = model_off.init(1, "cpu")
    batch = PPipeline(pcfg, PShape("t", SEQ, BATCH, "train"), seed=1,
                      device="cpu").make_batch(0)
    calls = []
    real = P_layers.checkpoint
    monkeypatch.setattr(P_layers, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss_off, g_off = _value_and_grad(model_off, params, batch)
    n_off = len(calls)
    loss_on, g_on = _value_and_grad(model_on, params, batch)
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)
    bodies = {"transformer": lambda c: c.n_layers // max(c.moe_every, 1),
              "mamba2": lambda c: c.n_layers,
              "rglru_hybrid": lambda c: c.n_layers // c.hybrid_period,
              "encdec": lambda c: c.n_layers + c.n_enc_layers,
              }[pcfg.family](pcfg)
    assert n_off == 1  # the CE chunk only
    # each body's checkpoint is entered once in the forward; under the
    # two-level form each layer's again when its block recomputes
    k = pcfg.remat_block
    if pcfg.family == "transformer" and k and bodies % k == 0:
        assert len(calls) - n_off == bodies // k + 2 * bodies + 1
    else:
        assert len(calls) - n_off == bodies + 1


def test_two_level_remat_changes_no_number(monkeypatch):
    """``remat_block`` = 2 on olmo's 4 layers: blocks of 2, each layer
    rematted inside its block (the reference's two-level form)."""
    _, pcfg = configs("olmo-1b")
    params = p_build_model(pcfg).init(2, "cpu")
    batch = PPipeline(pcfg, PShape("t", SEQ, BATCH, "train"), seed=2,
                      device="cpu").make_batch(0)
    outs = []
    for kw in (dict(remat=False), dict(remat=True, remat_block=2)):
        calls = []
        real = P_layers.checkpoint
        monkeypatch.setattr(P_layers, "checkpoint",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        model = p_build_model(dataclasses.replace(pcfg, **kw))
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = model.loss_fn(live, batch)
        n_fwd = len(calls)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        outs.append((loss, grads, n_fwd))
        monkeypatch.setattr(P_layers, "checkpoint", real)
    (l0, g0, n0), (l1, g1, n1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n0 == 1 and n1 == 1 + 2 + 4  # CE chunk, 2 blocks, 4 layers


# ---------------------------------------------------------------------------
# olmo-1b reduced: optimizers, microbatches, accumulation, compression
# ---------------------------------------------------------------------------


def _olmo_params():
    rcfg, _ = configs("olmo-1b")
    return to_np(r_build_model(rcfg).init(jax.random.PRNGKey(3)))


@pytest.mark.parametrize("opt_name", ("adamw", "adafactor"))
def test_three_steps_match(opt_name):
    """Three steps on the pipeline's batches 0-2.  Each port step starts
    from the reference's state of the step before (its rounding-sensitive
    entries would otherwise feed the next step's gradients), so steps 2
    and 3 check the bias corrections and Adafactor's decay schedule; the
    free-running port's losses and grad norms follow the reference's."""
    rcfg, pcfg = configs("olmo-1b")
    params = _olmo_params()
    ropt = R_opt.make_optimizer(opt_name, lr=LR)
    popt = P_opt.make_optimizer(opt_name, lr=LR)
    rstep = jax.jit(r_make_train_step(r_build_model(rcfg), ropt))
    pstep = p_make_train_step(p_build_model(pcfg), popt)
    rs = {"params": jax.tree.map(jnp.asarray, params),
          "opt": ropt.init(jax.tree.map(jnp.asarray, params))}
    free = port_state(popt, params)
    for step in range(3):
        rb, pb = batches(rcfg, pcfg, step=step)
        forced = params_from_numpy(to_np(rs), "cpu")
        rs, rm = rstep(rs, rb)
        ps, pm = pstep(forced, pb)
        assert_state_close(ps, to_np(rs), f"{opt_name} step {step}")
        assert_tree_close(pm, to_np(rm), f"{opt_name} step {step}")
        free, fm = pstep(free, pb)
        assert_tree_close(fm, to_np(rm), f"{opt_name} free step {step}")
    assert int(ps["opt"]["step"]) == int(free["opt"]["step"]) == 3


@pytest.mark.parametrize("accum", ("float32", "bfloat16"))
def test_microbatched_step_matches(accum):
    """Two microbatches of a batch of 4 against the reference's
    microbatched step; bf16 accumulation (the giants') at ``TOL_BF16``."""
    rcfg, pcfg = configs("olmo-1b", grad_accum_dtype=accum)
    tol = TOL if accum == "float32" else TOL_BF16
    params = _olmo_params()
    rb, pb = batches(rcfg, pcfg, batch=4)
    ropt = R_opt.make_optimizer("adamw", lr=LR)
    popt = P_opt.make_optimizer("adamw", lr=LR)
    rs, rm = jax.jit(r_make_train_step(r_build_model(rcfg), ropt,
                                       n_microbatches=2))(
        {"params": jax.tree.map(jnp.asarray, params),
         "opt": ropt.init(jax.tree.map(jnp.asarray, params))}, rb)
    pmodel = p_build_model(pcfg)
    ps, pm = p_make_train_step(pmodel, popt, n_microbatches=2)(
        port_state(popt, params), pb)
    assert_state_close(ps, to_np(rs), accum, tol)
    assert_tree_close(pm, to_np(rm), accum, tol)
    # and against the port's own single step on the whole batch
    s1, m1 = p_make_train_step(pmodel, popt)(port_state(popt, params), pb)
    np.testing.assert_allclose(float(m1["loss"]), float(pm["loss"]),
                               rtol=1e-4)


def quantizer_flips(got, want, path="") -> dict:
    """{parameter path: mask} of the residual entries outside ``TOL``.
    Each must be a rounding-boundary flip of the quantizer: the two
    packages' ``e`` straddle a quantization boundary, so their residuals
    lie on opposite sides of it, equal in size (one quantum apart).  Such
    an entry's quantized gradient, and so its moments and update, differ
    by that quantum."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(quantizer_flips(got[k], want[k],
                                       f"{path}/{k}" if path else k))
        return out
    g, w = got.numpy(), np.asarray(want)
    bad = ~np.isclose(g, w, **TOL)
    assert np.all(np.sign(g[bad]) == -np.sign(w[bad])), path
    np.testing.assert_allclose(np.abs(g[bad]), np.abs(w[bad]), rtol=0.05,
                               err_msg=path)
    return {path: torch.from_numpy(bad)} if bad.any() else {}


@pytest.mark.parametrize("kind", ("bf16", "int8"))
def test_compressed_steps_match(kind):
    """Two steps with error-feedback compression, the residual carried
    from the first into the second (the second from the reference's
    state, as in ``test_three_steps_match``).  An entry whose ``e`` falls
    on the other side of a quantization boundary in the two packages (a
    rounding decision, checked by :func:`quantizer_flips`) is left out of
    the comparison; at most FLIPS_MAX per step, of 0.2M entries.
    Measured (olmo-1b reduced, one thread): bf16 8 and 6 entries in its
    two steps (a bf16 quantum is 2^-8 of the value, so a 1e-7 relative
    difference of ``e`` crosses a boundary about once in 4e4 entries),
    int8 2 and 0."""
    rcfg, pcfg = configs("olmo-1b")
    params = _olmo_params()
    rmodel = r_build_model(rcfg)
    ropt = R_opt.make_optimizer("adamw", lr=LR)
    popt = P_opt.make_optimizer("adamw", lr=LR)
    rstep = jax.jit(r_make_train_step(rmodel, ropt, compression=RComp(kind)))
    pstep = p_make_train_step(p_build_model(pcfg), popt,
                              compression=PComp(kind))
    rp = jax.tree.map(jnp.asarray, params)
    rs = {"params": rp, "opt": ropt.init(rp),
          "resid": jax.tree.map(jnp.zeros_like, rp)}
    for step in range(2):
        rb, pb = batches(rcfg, pcfg, step=step)
        forced = params_from_numpy(to_np(rs), "cpu")
        rs, rm = rstep(rs, rb)
        ps, pm = pstep(forced, pb)
        assert sorted(ps) == ["opt", "params", "resid"]
        flips = quantizer_flips(ps["resid"], to_np(rs["resid"]))
        assert sum(int(m.sum()) for m in flips.values()) <= FLIPS_MAX
        assert_state_close(ps, to_np(rs), f"{kind} step {step}", skip=flips)
        assert_tree_close(pm, to_np(rm), f"{kind} step {step}")
    assert float(sum(r.abs().sum() for r in tree_leaves(ps["resid"]))) > 0


@pytest.mark.parametrize("kind", ("none", "bf16", "int8"))
def test_compress_grads_matches(kind):
    from repro.train.compression import compress_grads as r_compress
    from repro.train.compression import wire_fraction as r_wire
    from repro_torch.train.compression import compress_grads as p_compress
    from repro_torch.train.compression import wire_fraction as p_wire

    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((7, 5)).astype(np.float32),
         "b": {"c": (rng.standard_normal(11) * 1e-3).astype(np.float32)}}
    r = {"a": (rng.standard_normal((7, 5)) * 1e-2).astype(np.float32),
         "b": {"c": np.zeros(11, np.float32)}}
    want = r_compress(jax.tree.map(jnp.asarray, g),
                      jax.tree.map(jnp.asarray, r), RComp(kind))
    got = p_compress(params_from_numpy(g, "cpu"), params_from_numpy(r, "cpu"),
                     PComp(kind))
    assert_tree_close(got[0], to_np(want[0]), kind)
    assert_tree_close(got[1], to_np(want[1]), kind)
    assert p_wire(PComp(kind)) == r_wire(RComp(kind))


def test_clip_by_global_norm():
    g = {"a": torch.ones((10,)) * 3.0}
    clipped, norm = P_opt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(P_opt.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-6)
    rng = np.random.default_rng(1)
    tree = {"x": rng.standard_normal((4, 6)).astype(np.float32),
            "y": {"z": rng.standard_normal(9).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        want, wn = R_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                             max_norm)
        got, gn = P_opt.clip_by_global_norm(params_from_numpy(tree, "cpu"),
                                            max_norm)
        assert_tree_close(got, to_np(want))
        np.testing.assert_allclose(float(gn), float(wn), **TOL)


def test_adafactor_state_is_factored():
    rcfg, pcfg = configs("olmo-1b")
    pspecs = p_build_model(pcfg).param_specs()
    specs = P_opt.opt_state_specs("adafactor", pspecs)
    n_state = p_count_params(specs["v"])
    n_params = p_count_params(pspecs)
    assert n_state < 0.2 * n_params  # factored: far below 1 float per param
    rspecs = R_opt.opt_state_specs("adafactor",
                                   r_build_model(rcfg).param_specs())
    assert n_state == r_count_params(rspecs["v"])
    for name in ("adamw", "adafactor"):
        want = R_opt.opt_state_specs(name, r_build_model(rcfg).param_specs())
        got = P_opt.opt_state_specs(name, pspecs)
        assert jax.tree.map(lambda s: tuple(s.shape), want,
                            is_leaf=lambda x: hasattr(x, "axes")) == \
            tree_map(lambda s: tuple(s.shape), got)
    st = p_state_specs(p_build_model(pcfg), P_opt.make_optimizer("adamw"),
                       PComp("int8"))
    assert sorted(st) == ["opt", "params", "resid"]


def test_adamw_and_adafactor_reduce_loss():
    """The reference's smoke test: five steps on one batch lower the
    loss, for either optimizer."""
    _, pcfg = configs("olmo-1b")
    model = p_build_model(pcfg)
    batch = model.make_batch(7, PShape("t", SEQ, 4, "train"), "cpu")
    for name in ("adamw", "adafactor"):
        opt = P_opt.make_optimizer(name, lr=1e-3)
        step = p_make_train_step(model, opt)
        params = model.init(6, "cpu")
        state = {"params": params, "opt": opt.init(params)}
        losses = []
        for _ in range(5):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], (name,
                                                                     losses)


def test_serve_and_prefill_steps_match():
    """``make_prefill`` and ``make_serve_step``: the reference's greedy
    tokens from the same weights."""
    rcfg, pcfg = configs("olmo-1b")
    rmodel, pmodel = r_build_model(rcfg), p_build_model(pcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    pparams = params_from_numpy(to_np(params), "cpu")
    batch = rmodel.make_batch(jax.random.PRNGKey(1),
                              RShape("p", 16, 2, "prefill"))
    rt, rc = r_make_prefill(rmodel)(params, batch)
    pt, pc = p_make_prefill(pmodel)(
        pparams, {"tokens": tensor_from_numpy(np.asarray(batch["tokens"]),
                                              "cpu")})
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (2, 1)
    r_cache = rmodel.init_caches(2, 20)
    p_cache = pmodel.init_caches(2, 20, device="cpu")
    rn, _ = r_make_serve_step(rmodel)(params, r_cache, rt)
    pn, _ = p_make_serve_step(pmodel)(pparams, p_cache, pt)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))


# ---------------------------------------------------------------------------
# matmul_f32's backward (the card's bf16 branch, its product upcast here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", (((3, 5, 8), (8, 6)),
                                    ((2, 4, 3, 8), (2, 4, 8, 5)),
                                    ((2, 1, 3, 8), (1, 4, 8, 5))))
def test_matmul_f32_backward_is_jax_transpose(shapes, monkeypatch):
    """The bf16 branch's gradient rule against ``jax.grad`` of
    ``preferred_element_type=f32`` products of the same bf16 operands:
    each cotangent is an f32 product cast to bf16, so the two agree to
    one bf16 rounding (rtol 2^-7)."""
    monkeypatch.setattr(P_layers, "_bf16_product_f32",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(4)
    sa, sb = shapes
    a32 = rng.standard_normal(sa).astype(np.float32)
    b32 = rng.standard_normal(sb).astype(np.float32)
    w = rng.standard_normal(np.broadcast_shapes(sa[:-2], sb[:-2])
                            + (sa[-2], sb[-1])).astype(np.float32)
    ja, jb = jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16)

    def f(x, y):
        out = jnp.matmul(x, y, preferred_element_type=jnp.float32)
        return jnp.sum(out * w)

    wa, wb = jax.grad(f, argnums=(0, 1))(ja, jb)
    ta = tensor_from_numpy(np.asarray(ja), "cpu").requires_grad_(True)
    tb = tensor_from_numpy(np.asarray(jb), "cpu").requires_grad_(True)
    out = P_layers._MatmulF32.apply(ta, tb)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                 (ta, tb))
    assert ga.dtype == gb.dtype == torch.bfloat16
    for got, want in ((ga, wa), (gb, wb)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)
