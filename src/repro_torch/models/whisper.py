"""Whisper-medium backbone (enc-dec transformer) — arXiv:2212.04356.

The audio frontend (log-mel + conv downsampling) is a stub: the batch
carries precomputed frame embeddings (B, n_frames, d_model).  The
backbone: LayerNorm (with params), GELU MLPs, bidirectional encoder
self-attention, causal decoder self-attention + cross-attention over the
encoder output.  Positions are sinusoidal for both stacks (the JAX
package's deviation from Whisper's learned decoder positions, kept).
"""
from __future__ import annotations

import math

import torch

from ..config import ArchConfig
from .layers import (attention, embed, matmul_f32, merge_heads, mlp, norm,
                     remat, split_heads)
from .params import (ParamSpec, empty_caches, for_compute, logical_constraint,
                     weights_for_compute)
from .transformer import act_dtype, write_ring

__all__ = ["param_specs", "encode", "forward", "prefill", "decode_step",
           "cache_specs", "sinusoid_pos"]


def sinusoid_pos(positions, d: int):
    """Sinusoidal position embeddings.  positions: (S,) -> (S, d) f32."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg, lead, la, prefix=""):
    d, (qd, kvd) = cfg.d_model, cfg.qkv_dims
    return {
        prefix + "wq": ParamSpec(lead + (d, qd), la + ("embed", "heads")),
        prefix + "wk": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        prefix + "wv": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        prefix + "wo": ParamSpec(lead + (qd, d), la + ("heads", "embed")),
    }


def _ln(cfg, lead, la, name):
    return {
        name: ParamSpec(lead + (cfg.d_model,), la + ("embed",),
                        dtype=torch.float32, init="ones"),
        name + "_b": ParamSpec(lead + (cfg.d_model,), la + ("embed",),
                               dtype=torch.float32, init="zeros"),
    }


def _mlp_specs(cfg, lead, la):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec(lead + (d, f), la + ("embed", "mlp")),
        "wo_mlp": ParamSpec(lead + (f, d), la + ("mlp", "embed")),
    }


def param_specs(cfg: ArchConfig) -> dict:
    le, la = (cfg.n_enc_layers,), ("layers",)
    ld = (cfg.n_layers,)
    enc = {}
    enc.update(_ln(cfg, le, la, "ln1"))
    enc.update(_attn_specs(cfg, le, la))
    enc.update(_ln(cfg, le, la, "ln2"))
    enc.update(_mlp_specs(cfg, le, la))
    dec = {}
    dec.update(_ln(cfg, ld, la, "ln1"))
    dec.update(_attn_specs(cfg, ld, la))
    dec.update(_ln(cfg, ld, la, "lnx"))
    dec.update(_attn_specs(cfg, ld, la, prefix="x_"))
    dec.update(_ln(cfg, ld, la, "ln2"))
    dec.update(_mlp_specs(cfg, ld, la))
    specs = {
        "embed": ParamSpec((cfg.vocab_pad, cfg.d_model), ("vocab", "embed")),
        "enc_blocks": enc,
        "dec_blocks": dec,
    }
    specs.update(_ln(cfg, (), (), "enc_final"))
    specs.update(_ln(cfg, (), (), "dec_final"))
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _heads(x, w, n_heads, d_head):
    return split_heads(torch.matmul(x, w), n_heads, d_head)


def _self_attn(x, p, cfg, q_pos, kv_pos, causal, cache=None):
    """Self-attention; ``cache`` (k, v, kv_pos of this layer) is written
    in place."""
    s = x.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p["ln1"], p["ln1_b"], kind="layernorm")
    q = _heads(h, p["wq"], hq, dh)
    k = _heads(h, p["wk"], hkv, dh)
    v = _heads(h, p["wv"], hkv, dh)
    if cache is None or s > 1:
        if cache is not None:
            write_ring(cache, k, v, q_pos, prefill=True)
        o = attention(q, k, v, q_pos, kv_pos, causal=causal,
                      q_chunk=cfg.attn_q_chunk)
    else:
        write_ring(cache, k, v, q_pos, prefill=False)
        kv_valid = (cache["kv_pos"] >= 0)[None, :]
        o = attention(q, cache["k"], cache["v"], q_pos, cache["kv_pos"],
                      kv_valid=kv_valid, causal=True,
                      q_chunk=cfg.attn_q_chunk)
    o = torch.matmul(merge_heads(o), p["wo"])
    return x + o.to(x.dtype)


def _cross_attn(x, p, cfg, q_pos, xk, xv):
    """Cross-attention over precomputed encoder K/V."""
    hq, dh = cfg.n_heads, cfg.d_head
    h = norm(x, p["lnx"], p["lnx_b"], kind="layernorm")
    q = _heads(h, p["x_wq"], hq, dh)
    kv_pos = torch.arange(xk.shape[1], device=x.device)
    o = attention(q, xk, xv, q_pos, kv_pos, causal=False,
                  q_chunk=cfg.attn_q_chunk)
    o = torch.matmul(merge_heads(o), p["x_wo"])
    return x + o.to(x.dtype)


def _mlp_block(x, p):
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p["ln2"], p["ln2_b"], kind="layernorm")
    y = mlp(h, {"wi": p["wi"], "wo": p["wo_mlp"]}, act="gelu")
    return x + y.to(x.dtype)


def _unstack(blocks: dict) -> list:
    """Per-layer views of a stacked block tree (unbound once, so the
    backward stacks each weight's gradient once)."""
    per = {k: v.unbind(0) for k, v in blocks.items()}
    return [{k: per[k][i] for k in per}
            for i in range(len(next(iter(per.values()))))]


def encode(params, frames, cfg: ArchConfig):
    """Encoder over stub frame embeddings (B, n_frames, d)."""
    x = frames.to(act_dtype(cfg))
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)[None]

    def layer(h, blk):
        blk = weights_for_compute(blk)
        return _mlp_block(_self_attn(h, blk, cfg, pos, pos, causal=False),
                          blk)

    for blk in _unstack(params["enc_blocks"]):
        x = remat(layer, x, blk, on=cfg.remat)
    return norm(x, for_compute(params["enc_final"]),
                for_compute(params["enc_final_b"]), kind="layernorm")


def _enc_kv(params_dec, enc_out, cfg):
    """Per-layer cross K/V from the (final-normed) encoder output,
    stacked (l, B, S_enc, Hkv, D)."""
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    return {
        "xk": torch.stack([_heads(enc_out, for_compute(w), hkv, dh)
                           for w in params_dec["x_wk"].unbind(0)]),
        "xv": torch.stack([_heads(enc_out, for_compute(w), hkv, dh)
                           for w in params_dec["x_wv"].unbind(0)]),
    }


def _dec_layer(x, blk, cfg, q_pos, xk, xv, cache=None):
    blk = weights_for_compute(blk)
    x = _self_attn(x, blk, cfg, q_pos, q_pos, causal=True, cache=cache)
    x = _cross_attn(x, blk, cfg, q_pos, xk, xv)
    return _mlp_block(x, blk)


def _run_decoder(params, x, cfg, q_pos, enc_kv, caches=None):
    """Decoder layers (each rematted under ``cfg.remat`` when no cache is
    given); ``caches`` ({"self": stacked k/v/kv_pos/pos}) are written in
    place."""
    for i, blk in enumerate(_unstack(params["dec_blocks"])):
        xk, xv = enc_kv["xk"][i], enc_kv["xv"][i]
        if caches is None:
            x = remat(_dec_layer, x, blk, cfg, q_pos, xk, xv, on=cfg.remat)
            continue
        c = {n: caches["self"][n][i] for n in ("k", "v", "kv_pos")}
        x = _dec_layer(x, blk, cfg, q_pos, xk, xv, c)
    if caches is not None:
        caches["self"]["pos"] += x.shape[1]
    return x


def _embed_tokens(params, tokens, cfg, pos):
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    x = logical_constraint(x, ("batch", None, None))
    return x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)[None]


def forward(params, tokens, frames, cfg: ArchConfig):
    """Teacher-forced forward: encoder + decoder hidden states."""
    enc_kv = _enc_kv(params["dec_blocks"], encode(params, frames, cfg), cfg)
    q_pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_tokens(params, tokens, cfg, q_pos)
    x = _run_decoder(params, x, cfg, q_pos, enc_kv, None)
    return norm(x, for_compute(params["dec_final"]),
                for_compute(params["dec_final_b"]), kind="layernorm")


def _logits(params, hidden):
    return matmul_f32(hidden, for_compute(params["embed"].T))


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    l = cfg.n_layers
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    dt = act_dtype(cfg)
    kv_axes = ("layers", "batch", "kv_seq", "kv", None)
    enc_axes = ("layers", "batch", None, "kv", None)
    return {
        "dec": {
            "self": {
                "k": ParamSpec((l, batch, cache_len, hkv, dh), kv_axes,
                               dtype=dt, init="zeros"),
                "v": ParamSpec((l, batch, cache_len, hkv, dh), kv_axes,
                               dtype=dt, init="zeros"),
                "kv_pos": ParamSpec((l, cache_len), ("layers", "kv_seq"),
                                    dtype=torch.int32, init="zeros"),
                "pos": ParamSpec((l,), ("layers",), dtype=torch.int32,
                                 init="zeros"),
            }
        },
        "enc_kv": {
            "xk": ParamSpec((l, batch, cfg.n_frames, hkv, dh), enc_axes,
                            dtype=dt, init="zeros"),
            "xv": ParamSpec((l, batch, cfg.n_frames, hkv, dh), enc_axes,
                            dtype=dt, init="zeros"),
        },
    }


def prefill(params, tokens, frames, cfg: ArchConfig,
            cache_len: int | None = None):
    """Encode + teacher-forced decoder prefill; returns (logits, caches)."""
    enc_kv = _enc_kv(params["dec_blocks"], encode(params, frames, cfg), cfg)
    b, s = tokens.shape
    cache_len = max(cache_len or s, s)
    q_pos = torch.arange(s, device=tokens.device)
    x = _embed_tokens(params, tokens, cfg, q_pos)
    caches = empty_caches(cache_specs(cfg, b, cache_len)["dec"], x.device)
    x = _run_decoder(params, x, cfg, q_pos, enc_kv, caches)
    h_last = norm(x[:, -1], for_compute(params["dec_final"]),
                  for_compute(params["dec_final_b"]), kind="layernorm")
    return _logits(params, h_last), {"dec": caches, "enc_kv": enc_kv}


def decode_step(params, caches, tokens, cfg: ArchConfig):
    """One decode step with the self-KV ring and the fixed cross K/V."""
    q_pos = caches["dec"]["self"]["pos"][:1].long()
    x = _embed_tokens(params, tokens, cfg, q_pos)
    x = _run_decoder(params, x, cfg, q_pos, caches["enc_kv"], caches["dec"])
    h = norm(x[:, 0], for_compute(params["dec_final"]),
             for_compute(params["dec_final_b"]), kind="layernorm")
    return _logits(params, h), caches
