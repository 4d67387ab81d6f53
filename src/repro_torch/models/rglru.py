"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention,
in a (rec, rec, local-attn) repeating pattern — arXiv:2402.19427.

Temporal mix per layer:
  * recurrent block: two branches — gate = gelu(W_gate x); rec = RG-LRU(
    conv1d(W_rec x)); y = W_out (gate * rec)
  * local-attn block: GQA/MQA with a sliding window (bounded ring cache)
Each layer is followed by a GLU MLP; pre-RMSNorm residuals throughout.

The RG-LRU diagonal recurrence
  r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
  a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
is computed with the log-depth ``associative_scan`` (``models/scan.py``,
the reference's ``lax.associative_scan`` recursion) in train/prefill and
as an O(1) update in decode.

Parameters are stacked over super-blocks of ``hybrid_period`` sublayers;
the layers past the last whole period are trailing recurrent layers
(recurrentgemma-9b: 12 super-blocks + 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from .layers import (assign, attention, causal_conv1d, embed, gelu, matmul_f32,
                     merge_heads, mlp, norm, on_batch_shards, remat)
from .params import (ParamSpec, empty_caches, for_compute, logical_constraint,
                     tree_map, weights_for_compute)
from .scan import associative_scan
from .transformer import _qkv, act_dtype, write_ring

__all__ = [
    "param_specs",
    "forward",
    "prefill",
    "decode_step",
    "cache_specs",
    "rg_lru",
    "rg_lru_ref",
]

_C = 8.0  # Griffin's fixed gate sharpness


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def _lru_coeffs(x, p):
    """a (decay) and b (input) coefficient streams.  x: (B, S, W)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r  # (B, S, W)
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a^2), computed stably via expm1
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult * (i * xf)


def rg_lru(x, p, h0=None):
    """RG-LRU over a sequence via associative scan.

    x: (B, S, W).  Returns (y (B, S, W) f32, h_last (B, W) f32).
    """
    a, b = _lru_coeffs(x, p)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat(((b[:, 0] + a[:, 0] * h0.float())[:, None], b[:, 1:]),
                      dim=1)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, h = associative_scan(combine, (a, b), dim=1)
    return h, h[:, -1]


def rg_lru_ref(x, p, h0=None):
    """Sequential oracle for rg_lru (the reference's own, step by step)."""
    a, b = _lru_coeffs(x, p)
    bsz, s, w = x.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _rg_lru_step(x1, p, h0):
    """O(1) decode update.  x1: (B, 1, W); h0: (B, W)."""
    a, b = _lru_coeffs(x1, p)
    h = a[:, 0] * h0.float() + b[:, 0]
    return h[:, None], h


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _rec_specs(cfg: ArchConfig, lead, la) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    f32 = torch.float32
    return {
        "ln1": ParamSpec(lead + (d,), la + ("embed",), dtype=f32, init="ones"),
        "w_gate_in": ParamSpec(lead + (d, w), la + ("embed", "heads")),
        "w_rec_in": ParamSpec(lead + (d, w), la + ("embed", "heads")),
        "conv_w": ParamSpec(lead + (w, cfg.d_conv), la + ("heads", None)),
        "conv_b": ParamSpec(lead + (w,), la + ("heads",), init="zeros"),
        "w_a": ParamSpec(lead + (w, w), la + ("heads", None), dtype=f32,
                         scale=0.1),
        "b_a": ParamSpec(lead + (w,), la + (None,), dtype=f32, init="zeros"),
        "w_x": ParamSpec(lead + (w, w), la + ("heads", None), dtype=f32,
                         scale=0.1),
        "b_x": ParamSpec(lead + (w,), la + (None,), dtype=f32, init="zeros"),
        "lam": ParamSpec(lead + (w,), la + (None,), dtype=f32, init="ones"),
        "w_rec_out": ParamSpec(lead + (w, d), la + ("heads", "embed")),
    }


def _attn_specs(cfg: ArchConfig, lead, la) -> dict:
    d, (qd, kvd) = cfg.d_model, cfg.qkv_dims
    return {
        "ln1": ParamSpec(lead + (d,), la + ("embed",), dtype=torch.float32,
                         init="ones"),
        "wq": ParamSpec(lead + (d, qd), la + ("embed", "heads")),
        "wk": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        "wv": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        "wo": ParamSpec(lead + (qd, d), la + ("heads", "embed")),
    }


def _mlp_specs(cfg: ArchConfig, lead, la) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln2": ParamSpec(lead + (d,), la + ("embed",), dtype=torch.float32,
                         init="ones"),
        "wi_gate": ParamSpec(lead + (d, f), la + ("embed", "mlp")),
        "wi_up": ParamSpec(lead + (d, f), la + ("embed", "mlp")),
        "wo_mlp": ParamSpec(lead + (f, d), la + ("mlp", "embed")),
    }


def _layout(cfg: ArchConfig):
    """(n_super, trailing): whole periods + trailing recurrent layers."""
    period = cfg.hybrid_period or 3
    return cfg.n_layers // period, cfg.n_layers % period


def _restack(specs: dict, lead: tuple) -> dict:
    """Specs with their one leading layer dim replaced by ``lead``."""
    return {k: ParamSpec(lead + s.shape[1:],
                         ("layers",) + (None,) * (len(lead) - 1) + s.axes[1:],
                         dtype=s.dtype, init=s.init, scale=s.scale)
            for k, s in specs.items()}


def param_specs(cfg: ArchConfig) -> dict:
    period = cfg.hybrid_period or 3
    n_super, trailing = _layout(cfg)
    lead, la = (n_super,), ("layers",)
    # super-block: (period-1) recurrent sub-layers + 1 local-attn
    # sub-layer, each followed by an MLP
    specs = {
        "embed": ParamSpec((cfg.vocab_pad, cfg.d_model), ("vocab", "embed")),
        "blocks": {
            "rec": _restack(_rec_specs(cfg, lead, la), (n_super, period - 1)),
            "attn": _attn_specs(cfg, lead, la),
            "mlp": _restack(_mlp_specs(cfg, lead, la), (n_super, period)),
        },
        "final_norm": ParamSpec((cfg.d_model,), ("embed",),
                                dtype=torch.float32, init="ones"),
    }
    if trailing:
        specs["trailing"] = {
            "rec": _restack(_rec_specs(cfg, lead, la), (trailing,)),
            "mlp": _restack(_mlp_specs(cfg, lead, la), (trailing,)),
        }
    return specs


# ---------------------------------------------------------------------------
# Sub-layer application
# ---------------------------------------------------------------------------


def _rec_sublayer(x, p, cfg: ArchConfig, cache=None):
    """Recurrent temporal mix.  cache: {'h': (B, W), 'conv': (B, K-1, W)},
    written in place, or None."""
    x = logical_constraint(x, ("batch", None, None))
    h_in = norm(x, p["ln1"], kind=cfg.norm)
    gate = gelu(matmul_f32(h_in, p["w_gate_in"]))
    rec = matmul_f32(h_in, p["w_rec_in"]).to(x.dtype)
    rec, new_conv = causal_conv1d(
        rec, p["conv_w"], state=None if cache is None else cache["conv"])
    rec = rec + p["conv_b"].to(rec.dtype)
    if cache is not None and x.shape[1] == 1:
        y, new_h = _rg_lru_step(rec, p, cache["h"])
    else:
        lru = {k: p[k] for k in ("w_a", "b_a", "w_x", "b_x", "lam")}
        y, new_h = on_batch_shards(
            lambda x, h0, lru: rg_lru(x, lru, h0=h0),
            (rec, None if cache is None else cache["h"]), (lru,))
    out = matmul_f32((y * gate).to(x.dtype), p["w_rec_out"]).to(x.dtype)
    if cache is not None:
        assign(cache["h"], new_h)
        assign(cache["conv"], new_conv)
    return x + out


def _attn_sublayer(x, p, cfg: ArchConfig, q_pos, cache=None):
    """Local (sliding-window) attention with a ring cache written in
    place."""
    s = x.shape[1]
    window = cfg.window or 2048
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p["ln1"], kind=cfg.norm)
    q, k, v = _qkv(h, p, cfg, q_pos)
    if cache is None or s > 1:
        if cache is not None:
            write_ring(cache, k, v, q_pos, prefill=True)
        o = attention(q, k, v, q_pos, q_pos, causal=True, window=window,
                      q_chunk=cfg.attn_q_chunk)
    else:
        write_ring(cache, k, v, q_pos, prefill=False)
        kv_valid = (cache["kv_pos"] >= 0)[None, :]
        o = attention(q, cache["k"], cache["v"], q_pos, cache["kv_pos"],
                      kv_valid=kv_valid, causal=True, window=window,
                      q_chunk=cfg.attn_q_chunk)
    o = torch.matmul(merge_heads(o), p["wo"])
    return x + o.to(x.dtype)


def _mlp_sublayer(x, p, cfg: ArchConfig):
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p["ln2"], kind=cfg.norm)
    y = mlp(h, {"wi_gate": p["wi_gate"], "wi_up": p["wi_up"],
                "wo": p["wo_mlp"]}, act="silu_glu")
    return x + y.to(x.dtype)


def _pick(tree, *idx):
    return tree_map(lambda a: a[idx], tree)


def _weights(tree, *idx):
    """One sublayer's weights, in their compute layout on a mesh."""
    return weights_for_compute(_pick(tree, *idx))


def _super_block(x, blocks, i, cfg: ArchConfig, q_pos, caches=None):
    """Super-block ``i``: period-1 recurrent sublayers and one local-attn
    sublayer, each followed by an MLP."""
    period = cfg.hybrid_period or 3
    for j in range(period - 1):
        c = None if caches is None else _pick(caches["scan"]["rec"], i, j)
        x = _rec_sublayer(x, _weights(blocks["rec"], i, j), cfg, c)
        x = _mlp_sublayer(x, _weights(blocks["mlp"], i, j), cfg)
    c = None if caches is None else {
        n: caches["scan"]["attn"][n][i] for n in ("k", "v", "kv_pos")}
    x = _attn_sublayer(x, _weights(blocks["attn"], i), cfg, q_pos, c)
    return _mlp_sublayer(x, _weights(blocks["mlp"], i, period - 1), cfg)


def _run(params, x, cfg: ArchConfig, q_pos, caches=None):
    """Super-blocks (each rematted under ``cfg.remat`` when no cache is
    given, as the reference's scan body), then the trailing recurrent
    layers; ``caches`` are written in place."""
    blocks = params["blocks"]
    n_super = blocks["attn"]["wq"].shape[0]
    for i in range(n_super):
        if caches is None:
            x = remat(_super_block, x, blocks, i, cfg, q_pos,
                      on=cfg.remat)
        else:
            x = _super_block(x, blocks, i, cfg, q_pos, caches)
    if "trailing" in params:
        tr = params["trailing"]
        for j in range(tr["rec"]["w_a"].shape[0]):
            c = None if caches is None else _pick(caches["trailing"], j)
            x = _rec_sublayer(x, _weights(tr["rec"], j), cfg, c)
            x = _mlp_sublayer(x, _weights(tr["mlp"], j), cfg)
    if caches is not None:
        caches["scan"]["attn"]["pos"] += x.shape[1]
        caches["pos"] += x.shape[1]
    return x


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg):
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    return logical_constraint(x, ("batch", None, None))


def forward(params, tokens, cfg: ArchConfig):
    x = _embed(params, tokens, cfg)
    q_pos = torch.arange(x.shape[1], device=x.device)
    x = _run(params, x, cfg, q_pos, None)
    return norm(x, for_compute(params["final_norm"]), kind=cfg.norm)


def _logits(params, hidden):
    return matmul_f32(hidden, for_compute(params["embed"].T))


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    period = cfg.hybrid_period or 3
    n_super, trailing = _layout(cfg)
    w = cfg.lru_width or cfg.d_model
    skv = min(cache_len, cfg.window or 2048)
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    dt = act_dtype(cfg)

    def rec_cache(lead, la):
        return {
            "h": ParamSpec(lead + (batch, w), la + ("batch", "heads"),
                           dtype=torch.float32, init="zeros"),
            "conv": ParamSpec(lead + (batch, cfg.d_conv - 1, w),
                              la + ("batch", None, "heads"), dtype=dt,
                              init="zeros"),
        }

    kv_axes = ("layers", "batch", "kv_seq", "kv", None)
    specs = {
        "scan": {
            "rec": rec_cache((n_super, period - 1), ("layers", None)),
            "attn": {
                "k": ParamSpec((n_super, batch, skv, hkv, dh), kv_axes,
                               dtype=dt, init="zeros"),
                "v": ParamSpec((n_super, batch, skv, hkv, dh), kv_axes,
                               dtype=dt, init="zeros"),
                "kv_pos": ParamSpec((n_super, skv), ("layers", "kv_seq"),
                                    dtype=torch.int32, init="zeros"),
                "pos": ParamSpec((n_super,), ("layers",), dtype=torch.int32,
                                 init="zeros"),
            },
        },
        "pos": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }
    if trailing:
        specs["trailing"] = rec_cache((trailing,), ("layers",))
    return specs


def prefill(params, tokens, cfg: ArchConfig, cache_len: int | None = None):
    bsz, s = tokens.shape
    cache_len = max(cache_len or s, s)
    x = _embed(params, tokens, cfg)
    caches = empty_caches(cache_specs(cfg, bsz, cache_len), x.device)
    x = _run(params, x, cfg, torch.arange(s, device=x.device), caches)
    h_last = norm(x[:, -1], for_compute(params["final_norm"]), kind=cfg.norm)
    return _logits(params, h_last), caches


def decode_step(params, caches, tokens, cfg: ArchConfig):
    x = _embed(params, tokens, cfg)
    q_pos = caches["pos"].reshape(1).long()
    x = _run(params, x, cfg, q_pos, caches)
    h = norm(x[:, 0], for_compute(params["final_norm"]), kind=cfg.norm)
    return _logits(params, h), caches
