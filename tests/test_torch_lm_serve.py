"""The port's LM serving engine and ``--arch`` launcher, on the CPU.

``Engine.generate`` against the JAX package's engine for all ten
architectures at their ``reduced`` size, on the reference's own weights
and prompts carried across as numpy: the greedy tokens agree on every
step up to the first whose reference top-2 logit margin is at most
``TIE_MARGIN`` (there a near-tie may pick either token, and every later
step follows from that pick).  The reference's engine regressions
(``tests/test_serve.py``: n-1 decode steps, one token from prefill
alone, EOS first and mid-sequence) run on a counting toy model; decode
logits equal teacher-forced forward logits for the four cache families;
temperature sampling is reproducible from its seed; the launcher runs with
``--device cpu``.
"""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as R_config
from repro import configs as R_configs
from repro.models.api import build_model as r_build_model
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig

from repro_torch import config as P_config
from repro_torch import configs as P_configs
from repro_torch.launch import serve as P_launch
from repro_torch.models.api import build_model as p_build_model
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig

TOL = dict(rtol=3e-5, atol=1e-5)
ARCH_NAMES = sorted(R_configs.ARCHS)
NEW_TOKENS = 8
TIE_MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_generate(name):
    """The reference engine's greedy tokens, and the top-2 margin of the
    logits each token was picked from (a jitted prefill/decode loop)."""
    cfg = R_configs.reduced(R_configs.ARCHS[name])
    model = r_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = model.make_batch(jax.random.PRNGKey(2), R_config.ShapeConfig(
        "p", 24, 2, "prefill"))
    eng = REngine(model, params, RServeConfig(max_new_tokens=NEW_TOKENS))
    tokens = np.asarray(eng.generate(batch, key=jax.random.PRNGKey(0)))
    cache_len = (batch["tokens"].shape[1] + cfg.n_patches) + NEW_TOKENS
    logits, caches = jax.jit(model.prefill, static_argnames="cache_len")(
        params, batch, cache_len=cache_len)
    decode = jax.jit(model.decode_step)
    margins = []
    for i in range(NEW_TOKENS):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if i + 1 < NEW_TOKENS:
            logits, caches = decode(params, caches,
                                    jnp.asarray(tokens[:, i:i + 1]))
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, batch), tokens, np.stack(margins, 1))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_greedy_tokens_match_reference(name):
    params_np, batch_np, want, margins = _ref_generate(name)
    model = p_build_model(P_configs.reduced(P_configs.ARCHS[name]))
    params = params_from_numpy(params_np, "cpu")
    batch = {k: tensor_from_numpy(v, "cpu") for k, v in batch_np.items()}
    got = Engine(model, params, ServeConfig(max_new_tokens=NEW_TOKENS),
                 device="cpu").generate(batch).numpy()
    assert got.shape == want.shape == (2, NEW_TOKENS)
    for row in range(2):
        for i in range(NEW_TOKENS):
            if got[row, i] != want[row, i]:
                assert margins[row, i] <= TIE_MARGIN, (
                    f"row {row} step {i}: {got[row]} vs {want[row]}, "
                    f"margin {margins[row, i]}")
                break


# ---------------------------------------------------------------------------
# Engine decode-loop regressions (the reference's, on a counting toy model)
# ---------------------------------------------------------------------------


class _CountingModel:
    """Deterministic toy LM: next token is (tok + 1) mod V; every
    ``decode_step`` call is counted."""

    def __init__(self, v: int = 11):
        self.v = v
        self.calls = 0

    def _onehot(self, tok):
        return torch.nn.functional.one_hot(tok % self.v, self.v).float()

    def prefill(self, params, batch, cache_len):
        toks = batch["tokens"]
        return self._onehot(toks[:, -1].long()), torch.zeros(toks.shape[0])

    def decode_step(self, params, caches, tok):
        self.calls += 1
        return self._onehot(tok[:, 0] + 1), caches + 1


def _gen(model, tokens, **cfg):
    eng = Engine(model, params=None, cfg=ServeConfig(temperature=0.0, **cfg),
                 device="cpu")
    return eng.generate({"tokens": torch.tensor(tokens)}).numpy()


def test_generate_no_wasted_decode_step():
    """n new tokens cost exactly n-1 decode steps (the first token comes
    from prefill)."""
    m = _CountingModel()
    out = _gen(m, [[1, 2, 3], [5, 6, 7]], max_new_tokens=5)
    np.testing.assert_array_equal(out, [[3, 4, 5, 6, 7], [7, 8, 9, 10, 0]])
    assert m.calls == 4


def test_generate_single_token_no_decode():
    m = _CountingModel()
    out = _gen(m, [[4], [9]], max_new_tokens=1)
    np.testing.assert_array_equal(out, [[4], [9]])
    assert m.calls == 0


def test_generate_eos_on_first_token():
    """A sequence whose first token is EOS emits EOS from then on."""
    m = _CountingModel()
    out = _gen(m, [[3], [5]], max_new_tokens=4, eos_id=3)
    np.testing.assert_array_equal(out, [[3, 3, 3, 3], [5, 6, 7, 8]])


def test_generate_eos_mid_sequence():
    m = _CountingModel()
    out = _gen(m, [[4]], max_new_tokens=5, eos_id=6)
    np.testing.assert_array_equal(out, [[4, 5, 6, 6, 6]])


def test_temperature_sampling_follows_its_seed():
    cfg = P_configs.reduced(P_configs.ARCHS["olmo-1b"])
    model = p_build_model(cfg)
    params = model.init(0, device="cpu")
    batch = model.make_batch(1, P_config.ShapeConfig("p", 16, 2, "prefill"),
                             device="cpu")
    eng = Engine(model, params, ServeConfig(max_new_tokens=6,
                                            temperature=1.0), device="cpu")
    a, b, c = (eng.generate(batch, seed=s) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_pad


def test_engine_refuses_params_elsewhere():
    model = p_build_model(P_configs.reduced(P_configs.ARCHS["olmo-1b"]))
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="device"):
        Engine(model, params, device="meta")


# ---------------------------------------------------------------------------
# Decode against teacher forcing (the reference's test, on the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "h2o-danube-1.8b"])
def test_decode_matches_teacher_forcing(name):
    """Prefill 8 then decode 4 gives the teacher-forced forward logits at
    the same positions, for each cache family (KV, SSM state, RG-LRU
    state + local-attention ring, sliding window)."""
    cfg = P_configs.reduced(P_configs.ARCHS[name])
    model = p_build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12),
                                           dtype=np.int32))
    hidden = model.forward(params, {"tokens": torch.nn.functional.pad(
        tokens, (0, 1))})
    tf_logits = hidden @ params["embed"].T
    lp, caches = model.prefill(params, {"tokens": tokens[:, :8]},
                               cache_len=12)
    np.testing.assert_allclose(lp.numpy(), tf_logits[:, 7].numpy(), **TOL)
    for i in range(8, 12):
        ld, caches = model.decode_step(params, caches, tokens[:, i:i + 1])
        np.testing.assert_allclose(ld.numpy(), tf_logits[:, i].numpy(),
                                   **TOL)


# ---------------------------------------------------------------------------
# The --arch launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", (
    ["--arch", "olmo-1b"],
    ["--arch", "whisper-medium", "--temperature", "0.7", "--batch", "2"],
    ["--arch", "pixtral-12b", "--prompt-len", "24", "--new-tokens", "5"],
))
def test_serve_launcher_runs_on_the_cpu(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = P_launch.main(argv + ["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 2, lines
    assert lines[0].startswith(f"[serve] arch={argv[1]}-smoke device=cpu")
    assert "tok/s" in lines[0] and lines[1].startswith(
        "[serve] first sequence:")
