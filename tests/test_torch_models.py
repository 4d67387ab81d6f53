"""The port's LM stack against the JAX package's, on the CPU.

For every one of the ten architectures at its ``reduced`` size (f32,
<= 4 layers, d_model 64) the JAX package builds the parameters
(``init(PRNGKey(0))``) and the batches; both go across as numpy arrays
through ``repro_torch.models.convert``, so no test relies on matching
random streams.  Held at ``TOL`` (rtol 3e-5, atol 1e-5): the configs
field for field, the parameter and cache spec trees (keys, shapes,
dtypes), ``count_params`` of the full configs (no allocation), forward
hidden states, ``loss_fn``, prefill logits and every cache leaf, three
decode steps fed the reference's own greedy tokens, and the shared
layers (``attention`` with window and padded query chunks, ``moe``,
``moe_grouped``, ``ssd_chunked``/``ssd_ref``, ``rg_lru``).

The prompt is 24 positions with decode headroom 3, so the reduced
sliding windows (16: h2o-danube, recurrentgemma) are crossed: the ring
cache keeps only the last 16 positions at slot ``pos % 16``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as R_config
from repro import configs as R_configs
from repro.models import layers as R_layers
from repro.models import mamba2 as R_mamba2
from repro.models import rglru as R_rglru
from repro.models.api import build_model as r_build_model
from repro.models.params import count_params as r_count_params

from repro_torch import config as P_config
from repro_torch import configs as P_configs
from repro_torch.models import layers as P_layers
from repro_torch.models import mamba2 as P_mamba2
from repro_torch.models import rglru as P_rglru
from repro_torch.models.api import build_model as p_build_model
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.params import count_params as p_count_params
from repro_torch.models.params import tree_leaves, tree_map

TOL = dict(rtol=3e-5, atol=1e-5)
ARCH_NAMES = sorted(R_configs.ARCHS)
TRAIN = dict(seq_len=24, global_batch=2)
PROMPT = 24  # positions in the prefill (patches included)
N_DECODE = 3


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


def port_np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def assert_tree_close(got, want, where="", tol=TOL):
    """Same keys, shapes and dtypes; values at ``tol`` (ints exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_tree_close(got[k], want[k], f"{where}/{k}", tol)
        return
    want = np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, err_msg=where, **tol)


def spec_tree(tree):
    """{key: (shape, dtype name)} of a ParamSpec tree of either package."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    return tuple(tree.shape), dtype_name(tree.dtype)


def dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt))


def _ref_run(name):
    """The reference's params, batches and outputs for one reduced arch,
    all as numpy."""
    cfg = R_configs.reduced(R_configs.ARCHS[name])
    model = r_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    train = model.make_batch(jax.random.PRNGKey(1), R_config.ShapeConfig(
        "t", TRAIN["seq_len"], TRAIN["global_batch"], "train"))
    pre = model.make_batch(jax.random.PRNGKey(2), R_config.ShapeConfig(
        "p", PROMPT, 2, "prefill"))
    n_pos = pre["tokens"].shape[1] + (cfg.n_patches or 0)
    out = {"params": to_np(params), "train": to_np(train), "pre": to_np(pre),
           "hidden": np.asarray(jax.jit(model.forward)(params, train)),
           "loss": np.asarray(jax.jit(model.loss_fn)(params, train)),
           "cache_len": n_pos + N_DECODE}
    prefill = jax.jit(model.prefill, static_argnames="cache_len")
    logits, caches = prefill(params, pre, cache_len=out["cache_len"])
    out["prefill"] = (np.asarray(logits), to_np(caches))
    steps = []
    decode = jax.jit(model.decode_step)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(N_DECODE):
        logits, caches = decode(params, caches, tok)
        steps.append((np.asarray(tok), np.asarray(logits), to_np(caches)))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _ref_run(name)
        return cache[name]

    return get


def port(name, r):
    cfg = P_configs.reduced(P_configs.ARCHS[name])
    return (p_build_model(cfg), params_from_numpy(r["params"], "cpu"))


def port_batch(b):
    return {k: tensor_from_numpy(v, "cpu") for k, v in b.items()}


# ---------------------------------------------------------------------------
# Configs and spec trees (no allocation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_match_field_for_field(name):
    full_r, full_p = R_configs.ARCHS[name], P_configs.ARCHS[name]
    for r_cfg, p_cfg in ((full_r, full_p),
                         (R_configs.reduced(full_r), P_configs.reduced(full_p))):
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
        assert p_cfg.vocab_pad == r_cfg.vocab_pad
        assert p_cfg.sub_quadratic == r_cfg.sub_quadratic
        assert p_cfg.qkv_dims == r_cfg.qkv_dims
        assert p_cfg.n_ssm_heads == r_cfg.n_ssm_heads
        assert p_cfg.n_params() == r_cfg.n_params()
        assert p_cfg.n_active_params() == r_cfg.n_active_params()
        for s in R_config.SHAPES:
            assert P_configs.cell_skip_reason(p_cfg, P_config.SHAPES[s]) == \
                R_configs.cell_skip_reason(r_cfg, R_config.SHAPES[s])


def test_registry_and_shapes_match():
    assert list(P_configs.ARCHS) == list(R_configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in P_config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_config.SHAPES.items()}
    assert P_configs.runnable_cells() == R_configs.runnable_cells()
    assert [P_config.pad_vocab(v) for v in (1, 16, 50280, 51865)] == \
        [R_config.pad_vocab(v) for v in (1, 16, 50280, 51865)]
    with pytest.raises(KeyError, match="unknown arch"):
        P_configs.get_arch("gpt-5")


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("size", ("full", "reduced"))
def test_param_and_cache_specs_match(name, size):
    r_cfg, p_cfg = R_configs.ARCHS[name], P_configs.ARCHS[name]
    if size == "reduced":
        r_cfg, p_cfg = R_configs.reduced(r_cfg), P_configs.reduced(p_cfg)
    rm, pm = r_build_model(r_cfg), p_build_model(p_cfg)
    assert spec_tree(pm.param_specs()) == spec_tree(rm.param_specs())
    assert spec_tree(pm.cache_specs(4, 96)) == spec_tree(rm.cache_specs(4, 96))
    shape = R_config.ShapeConfig("p", 2048, 4, "prefill")
    want = {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in rm.input_specs(shape).items()}
    got = {k: (shp, dtype_name(dt))
           for k, (shp, dt) in pm.input_specs(P_config.ShapeConfig(
               "p", 2048, 4, "prefill")).items()}
    assert got == want


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_of_full_configs(name):
    r_specs = r_build_model(R_configs.ARCHS[name]).param_specs()
    pm = p_build_model(P_configs.ARCHS[name])
    n = p_count_params(pm.param_specs())
    assert n == r_count_params(r_specs)
    meta = pm.abstract_params()
    assert p_count_params(meta) == n
    assert all(t.device.type == "meta" for t in tree_leaves(meta))


# ---------------------------------------------------------------------------
# The model at reduced size: forward, loss, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_and_loss_match(ref, name):
    r = ref(name)
    model, params = port(name, r)
    batch = port_batch(r["train"])
    np.testing.assert_allclose(model.forward(params, batch).numpy(),
                               r["hidden"], **TOL)
    np.testing.assert_allclose(float(model.loss_fn(params, batch)),
                               float(r["loss"]), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_logits_and_caches_match(ref, name):
    r = ref(name)
    model, params = port(name, r)
    logits, caches = model.prefill(params, port_batch(r["pre"]),
                                   cache_len=r["cache_len"])
    want_logits, want_caches = r["prefill"]
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert_tree_close(port_np(caches), want_caches, name)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_steps_match(ref, name):
    """Three decode steps from the port's own prefill, each fed the token
    the reference chose, against the reference's logits and caches."""
    r = ref(name)
    model, params = port(name, r)
    _, caches = model.prefill(params, port_batch(r["pre"]),
                              cache_len=r["cache_len"])
    for i, (tok, want_logits, want_caches) in enumerate(r["decode"]):
        logits, caches = model.decode_step(params, caches,
                                           tensor_from_numpy(tok, "cpu"))
        np.testing.assert_allclose(logits.numpy(), want_logits,
                                   err_msg=f"step {i}", **TOL)
        assert_tree_close(port_np(caches), want_caches, f"{name} step {i}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_from_reference_caches(ref, name):
    """A decode step started from the reference's own caches (carried
    across by ``params_from_numpy``) gives the reference's next logits."""
    r = ref(name)
    model, params = port(name, r)
    _, want_logits, _ = r["decode"][1]
    caches = params_from_numpy(r["decode"][0][2], "cpu")
    logits, _ = model.decode_step(params, caches,
                                  tensor_from_numpy(r["decode"][1][0], "cpu"))
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)


@pytest.mark.parametrize("name", ("h2o-danube-1.8b", "recurrentgemma-9b"))
def test_prefill_crosses_the_window(ref, name):
    """The prompt (24) is longer than the reduced window (16): the ring
    holds only the last 16 positions, each at slot pos % 16."""
    r = ref(name)
    model, params = port(name, r)
    _, caches = model.prefill(params, port_batch(r["pre"]),
                              cache_len=r["cache_len"])
    kv_pos = (caches["kv_pos"] if "kv_pos" in caches
              else caches["scan"]["attn"]["kv_pos"])
    want = np.arange(8, 24)
    want = want[np.argsort(want % 16)]
    for row in kv_pos.reshape(-1, 16).numpy():
        np.testing.assert_array_equal(row, want)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_caches_match(name):
    rm = r_build_model(R_configs.reduced(R_configs.ARCHS[name]))
    pm = p_build_model(P_configs.reduced(P_configs.ARCHS[name]))
    assert_tree_close(port_np(pm.init_caches(2, 20, device="cpu")),
                      to_np(rm.init_caches(2, 20)), name)


@pytest.mark.parametrize("name", ("olmo-1b", "pixtral-12b", "whisper-medium"))
def test_init_and_make_batch(name):
    """The port's own draws: the reference's rule (zeros, ones, or a
    normal scaled by 1/sqrt(fan_in)) on every leaf, reproducible from the
    seed, and batches in range."""
    cfg = P_configs.reduced(P_configs.ARCHS[name])
    model = p_build_model(cfg)
    specs = model.param_specs()
    a, b = model.init(3, "cpu"), model.init(3, "cpu")
    for s, x, y in zip(tree_leaves(specs), tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and x.dtype == s.dtype
        if s.init == "zeros":
            assert not x.any()
        elif s.init == "ones":
            assert bool((x == 1).all())
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = float(x.float().std())
            assert abs(std * fan_in ** 0.5 / s.scale - 1) < 0.1
    batch = model.make_batch(5, P_config.ShapeConfig("p", 24, 2, "prefill"),
                             "cpu")
    tok = batch["tokens"]
    assert tok.dtype == torch.int32 and int(tok.min()) >= 0
    assert int(tok.max()) < cfg.vocab
    assert not any(k not in ("tokens", "patches", "frames") for k in batch)


def test_too_short_a_pixtral_prompt_is_refused():
    model = p_build_model(P_configs.ARCHS["pixtral-12b"])
    with pytest.raises(ValueError, match="patch"):
        model.input_specs(P_config.ShapeConfig("serve", 64, 4, "prefill"))


def test_bf16_crosses_bit_for_bit():
    a = np.asarray(jnp.asarray(_rand(0, (5, 7))).astype(jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    tree = params_from_numpy({"w": a, "pos": np.int32(3)}, "cpu")
    assert tree["pos"].dtype == torch.int32 and tree["pos"].dim() == 0


# ---------------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------------


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ("causal", "window", "padded_chunks",
                                  "cache_valid"))
def test_attention_matches(case):
    b, sq, hq, hkv, d = 2, 20, 4, 2, 8
    q, k, v = (_rand(i, (b, sq, h, d)) for i, h in ((0, hq), (1, hkv),
                                                    (2, hkv)))
    q_pos = np.arange(sq, dtype=np.int32)
    kv_pos, kv_valid = q_pos, None
    kw = dict(causal=True, window=None, q_chunk=1024)
    if case == "window":
        kw["window"] = 5
    elif case == "padded_chunks":  # 20 queries in chunks of 8: 4 padded
        kw.update(window=7, q_chunk=8)
    elif case == "cache_valid":
        kv_pos = np.where(np.arange(sq) < 13, q_pos, -1).astype(np.int32)
        kv_valid = np.broadcast_to(kv_pos >= 0, (b, sq)).copy()
        kv_valid[1, 4] = False
        kw["causal"] = False
    want = R_layers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos),
        None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = P_layers.attention(t(q), t(k), t(v), t(q_pos), t(kv_pos),
                             None if kv_valid is None else t(kv_valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_params(e, d, f):
    return {"router": _rand(10, (d, e), d ** -0.5),
            "wi_gate": _rand(11, (e, d, f), d ** -0.5),
            "wi_up": _rand(12, (e, d, f), d ** -0.5),
            "wo": _rand(13, (e, f, d), f ** -0.5)}


@pytest.mark.parametrize("impl,top_k,tokens", (
    ("scatter", 1, 16), ("scatter", 2, 64), ("grouped", 2, 48),
    ("grouped", 1, 40), ("grouped_chunked", 2, 64)))
def test_moe_matches(impl, top_k, tokens):
    """Capacity drops included: 64 tokens on 4 experts at top-2 overflow
    the capacity; grouped at 48 and 40 tokens halves the group size until
    it divides the token count."""
    e, d, f = 4, 16, 8
    x = _rand(14, (2, tokens // 2, d))
    p = _moe_params(e, d, f)
    if impl == "scatter":
        rfn, pfn, kw = R_layers.moe, P_layers.moe, {}
    else:
        rfn, pfn = R_layers.moe_grouped, P_layers.moe_grouped
        kw = dict(group_size=32,
                  group_chunk=2 if impl == "grouped_chunked" else 1)
    want, want_probs = rfn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), e,
                           top_k, 1.25, **kw)
    got, got_probs = pfn(torch.from_numpy(x), params_from_numpy(p, "cpu"),
                         e, top_k, 1.25, **kw)
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(want_probs),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g,with_h0", ((1, False), (2, True)))
def test_ssd_chunked_matches(g, with_h0):
    """The port's chunked SSD against its own sequential oracle and
    against the reference's chunked SSD, with and without a carried
    state."""
    bsz, s, h, p, n = 2, 32, 4, 8, 6
    x = _rand(20, (bsz, s, h, p))
    dt = np.log1p(np.exp(_rand(21, (bsz, s, h))))
    a_log = _rand(22, (h,), 0.5)
    b, c = _rand(23, (bsz, s, g, n)), _rand(24, (bsz, s, g, n))
    d_skip = _rand(25, (h,))
    h0 = _rand(26, (bsz, h, p, n)) if with_h0 else None
    args = (x, dt, a_log, b, c, d_skip)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y, hf = P_mamba2.ssd_chunked(*map(t, args), 8, h0=t(h0))
    y_ref, hf_ref = P_mamba2.ssd_ref(*map(t, args), h0=t(h0))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    np.testing.assert_allclose(hf.numpy(), hf_ref.numpy(), **TOL)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    y_r, hf_r = R_mamba2.ssd_chunked(*map(j, args), 8, h0=j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_r), **TOL)


@pytest.mark.parametrize("with_h0", (False, True))
def test_rg_lru_matches(with_h0):
    """The log-depth scan against the reference's associative scan, and
    against the sequential oracle."""
    bsz, s, w = 2, 24, 16
    x = _rand(30, (bsz, s, w))
    p = {"w_a": _rand(31, (w, w), 0.1 / w ** 0.5),
         "b_a": _rand(32, (w,), 0.1),
         "w_x": _rand(33, (w, w), 0.1 / w ** 0.5),
         "b_x": _rand(34, (w,), 0.1),
         "lam": _rand(35, (w,))}
    h0 = _rand(36, (bsz, w)) if with_h0 else None
    want_y, want_h = R_rglru.rg_lru(jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, p),
                                    None if h0 is None else jnp.asarray(h0))
    pp = params_from_numpy(p, "cpu")
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = P_rglru.rg_lru(torch.from_numpy(x), pp, th0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    y2, h2 = P_rglru.rg_lru_ref(torch.from_numpy(x), pp, th0)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h2.numpy(), **TOL)


def test_norms_rope_conv_match():
    x = _rand(40, (2, 6, 4, 8))
    pos = np.arange(6, dtype=np.int32) + 5
    np.testing.assert_allclose(
        P_layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(R_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **TOL)
    y = _rand(41, (2, 6, 16))
    sc, bi = _rand(42, (16,)), _rand(43, (16,))
    for kind in ("rmsnorm", "layernorm", "nonparametric"):
        np.testing.assert_allclose(
            P_layers.norm(torch.from_numpy(y), torch.from_numpy(sc),
                          torch.from_numpy(bi), kind).numpy(),
            np.asarray(R_layers.norm(jnp.asarray(y), jnp.asarray(sc),
                                     jnp.asarray(bi), kind)), **TOL)
    w, st = _rand(44, (16, 4)), _rand(45, (2, 3, 16))
    for state in (None, st):
        got = P_layers.causal_conv1d(
            torch.from_numpy(y), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        want = R_layers.causal_conv1d(
            jnp.asarray(y), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
