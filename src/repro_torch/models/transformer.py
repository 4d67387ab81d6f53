"""Decoder-only transformer family (dense / GQA / SWA / MoE / VLM-backbone).

Covers: olmo-1b (non-parametric LN), granite-8b, stablelm-3b,
h2o-danube-1.8b (SWA), pixtral-12b (stub patch embeds + mistral-nemo
backbone), qwen3-moe-235b (top-8, every layer), llama4-maverick-400b
(top-1, alternating dense/MoE).

Parameters are stacked over super-blocks of ``moe_every`` sublayers (the
last sublayer of a block is MoE when configured), as in the JAX package;
here a Python loop runs the super-blocks (no scan).  With ``cfg.remat``
a training forward rematerializes each super-block, or, where
``remat_block`` = k divides their count, each block of k and each
super-block inside it (the reference's two-level form).  Decode
caches are a ring per sublayer: slot ``pos % skv`` holds position
``pos``, and ``kv_pos`` (-1 = empty) says which.  :func:`decode_step`
writes its slot in place and returns the same cache tree.
"""
from __future__ import annotations

import torch

from ..config import ArchConfig
from .layers import (assign, attention, embed, matmul_f32, merge_heads, mlp,
                     moe, moe_grouped, norm, remat, rope, split_heads,
                     write_slot)
from .params import (ParamSpec, empty_caches, for_compute, logical_constraint,
                     weights_for_compute)

__all__ = [
    "param_specs",
    "forward",
    "logits_from_hidden",
    "prefill",
    "decode_step",
    "cache_specs",
]

_MOE_KEYS = ("router", "e_wi_gate", "e_wi_up", "e_wo")


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _norm_spec(cfg, lead=()):
    if cfg.norm == "nonparametric":
        return None
    return ParamSpec(lead + (cfg.d_model,),
                     tuple([None] * len(lead)) + ("embed",),
                     dtype=torch.float32, init="ones")


def _block_specs(cfg: ArchConfig) -> dict:
    """Specs for one super-block stack (moe_every sublayers each)."""
    l = cfg.n_layers // max(cfg.moe_every, 1)
    sub = max(cfg.moe_every, 1)
    d, qd, kvd, f = cfg.d_model, *cfg.qkv_dims, cfg.d_ff
    lead = (l, sub)
    la = ("layers", None)
    specs = {
        "wq": ParamSpec(lead + (d, qd), la + ("embed", "heads")),
        "wk": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        "wv": ParamSpec(lead + (d, kvd), la + ("embed", "kv")),
        "wo": ParamSpec(lead + (qd, d), la + ("heads", "embed")),
    }
    for nm in ("ln1", "ln2"):
        ns = _norm_spec(cfg, lead)
        if ns is not None:
            specs[nm] = ns
    # dense FFN weights exist for every sublayer unless every layer is MoE
    if not (cfg.n_experts and cfg.moe_every == 1):
        if cfg.act == "silu_glu":
            specs["wi_gate"] = ParamSpec(lead + (d, f), la + ("embed", "mlp"))
            specs["wi_up"] = ParamSpec(lead + (d, f), la + ("embed", "mlp"))
        else:
            specs["wi"] = ParamSpec(lead + (d, f), la + ("embed", "mlp"))
        specs["wo_mlp"] = ParamSpec(lead + (f, d), la + ("mlp", "embed"))
    if cfg.n_experts:
        e, fe = cfg.n_experts, cfg.d_ff_expert
        specs["router"] = ParamSpec((l, d, e), ("layers", "embed", None),
                                    dtype=torch.float32)
        specs["e_wi_gate"] = ParamSpec((l, e, d, fe),
                                       ("layers", "experts", "embed", "mlp"))
        specs["e_wi_up"] = ParamSpec((l, e, d, fe),
                                     ("layers", "experts", "embed", "mlp"))
        specs["e_wo"] = ParamSpec((l, e, fe, d),
                                  ("layers", "experts", "mlp", "embed"))
    return specs


def param_specs(cfg: ArchConfig) -> dict:
    specs = {
        "embed": ParamSpec((cfg.vocab_pad, cfg.d_model), ("vocab", "embed"),
                           scale=1.0),
        "blocks": _block_specs(cfg),
    }
    fn = _norm_spec(cfg)
    if fn is not None:
        specs["final_norm"] = fn
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_pad),
                                     ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Sub-layer application
# ---------------------------------------------------------------------------


def _sub(blk, j):
    """Sublayer j of one super-block's params (MoE weights are per block)."""
    return {k: (v if k in _MOE_KEYS else v[j]) for k, v in blk.items()}


def write_ring(cache: dict, k, v, q_pos, prefill: bool) -> None:
    """Write new keys/values into a ring cache in place.

    cache: k/v (B, skv, Hkv, D), kv_pos (skv,).  Decode (one token) writes
    slot ``pos % skv``; prefill (positions ``0 .. s-1``) writes the last
    ``skv`` tokens at their slots and marks every other slot empty (-1):
    the last ``n = min(s, skv)`` rows, padded to ``skv``, rolled by the
    slot of their first position.
    """
    skv = cache["k"].shape[1]
    if prefill:
        n = min(k.shape[1], skv)
        r = (k.shape[1] - n) % skv

        def ring(x, fill):
            x = x[:, -n:]
            if n < skv:
                pad = torch.full((x.shape[0], skv - n) + tuple(x.shape[2:]),
                                 fill, dtype=x.dtype, device=x.device)
                x = torch.cat([x, pad], dim=1)
            return torch.roll(x, r, dims=1) if r else x

        assign(cache["k"], ring(k, 0))
        assign(cache["v"], ring(v, 0))
        assign(cache["kv_pos"], ring(q_pos.to(torch.int32)[None], -1)[0])
    else:
        slot = (q_pos % skv).long()
        write_slot(cache["k"], 1, slot, k)
        write_slot(cache["v"], 1, slot, v)
        write_slot(cache["kv_pos"], 0, slot, q_pos.to(torch.int32))


def _qkv(h, p, cfg: ArchConfig, q_pos):
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = split_heads(torch.matmul(h, p["wq"]), hq, dh)
    k = split_heads(torch.matmul(h, p["wk"]), hkv, dh)
    v = split_heads(torch.matmul(h, p["wv"]), hkv, dh)
    return rope(q, q_pos, cfg.rope_theta), rope(k, q_pos, cfg.rope_theta), v


def _attn_sublayer(x, p, cfg: ArchConfig, q_pos, cache=None):
    """Pre-norm attention.  cache: dict(k, v, kv_pos) of this sublayer,
    written in place, or None."""
    s = x.shape[1]
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p.get("ln1"), kind=cfg.norm)
    q, k, v = _qkv(h, p, cfg, q_pos)
    q = logical_constraint(q, ("batch", None, "heads", None))
    k = logical_constraint(k, ("batch", None, "kv", None))
    v = logical_constraint(v, ("batch", None, "kv", None))
    if cache is None or s > 1:
        if cache is not None:
            write_ring(cache, k, v, q_pos, prefill=True)
        o = attention(q, k, v, q_pos, q_pos, causal=True, window=cfg.window,
                      q_chunk=cfg.attn_q_chunk)
    else:
        write_ring(cache, k, v, q_pos, prefill=False)
        kv_valid = (cache["kv_pos"] >= 0)[None, :]
        o = attention(q, cache["k"], cache["v"], q_pos, cache["kv_pos"],
                      kv_valid=kv_valid, causal=False, window=cfg.window,
                      q_chunk=cfg.attn_q_chunk)
    o = torch.matmul(merge_heads(o), p["wo"])
    return x + o.to(x.dtype)


def _ffn_sublayer(x, p, cfg: ArchConfig, is_moe: bool):
    x = logical_constraint(x, ("batch", None, None))
    h = norm(x, p.get("ln2"), kind=cfg.norm)
    if is_moe:
        mp = {"router": p["router"], "wi_gate": p["e_wi_gate"],
              "wi_up": p["e_wi_up"], "wo": p["e_wo"]}
        if cfg.moe_impl == "grouped":
            y, _ = moe_grouped(h, mp, cfg.n_experts, cfg.top_k,
                               cfg.capacity_factor, group_size=cfg.moe_group,
                               group_chunk=cfg.moe_group_chunk)
        else:
            y, _ = moe(h, mp, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    else:
        mp = {k: p[k] for k in ("wi_gate", "wi_up", "wi") if k in p}
        mp["wo"] = p["wo_mlp"]
        y = mlp(h, mp, act=cfg.act)
    return x + y.to(x.dtype)


def _super_block(x, blk, cfg: ArchConfig, q_pos, caches=None, i=0):
    """The ``moe_every`` sublayers of one super-block (the last one MoE
    when configured); ``caches`` are written in place."""
    sub = max(cfg.moe_every, 1)
    blk = weights_for_compute(blk)
    for j in range(sub):
        p = _sub(blk, j)
        c = None if caches is None else {
            n: caches[n][i, j] for n in ("k", "v", "kv_pos")}
        x = _attn_sublayer(x, p, cfg, q_pos, c)
        x = _ffn_sublayer(x, p, cfg, bool(cfg.n_experts) and j == sub - 1)
    return x


def _run_blocks(params, x, cfg: ArchConfig, q_pos, caches=None):
    """Every super-block in turn; ``caches`` (stacked (l, sub, ...)) are
    written in place.  The stacked weights are unbound once, so the
    backward stacks each weight's gradient once."""
    blocks = params["blocks"]
    n_sb = blocks["wq"].shape[0]
    per = {k: v.unbind(0) for k, v in blocks.items()}
    blks = [{k: per[k][i] for k in per} for i in range(n_sb)]
    if caches is not None:
        for i, blk in enumerate(blks):
            x = _super_block(x, blk, cfg, q_pos, caches, i)
        caches["pos"] += x.shape[1]
        return x

    def layer(h, blk):
        return _super_block(h, blk, cfg, q_pos)

    k = cfg.remat_block
    if cfg.remat and k and n_sb % k == 0:
        # two-level remat: activations are kept only at the boundaries of
        # blocks of k; the k layers inside recompute in the backward
        def group(h, grp):
            for blk in grp:
                h = remat(layer, h, blk)
            return h

        for g in range(0, n_sb, k):
            x = remat(group, x, blks[g:g + k])
        return x
    for blk in blks:
        x = remat(layer, x, blk, on=cfg.remat)
    return x


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _embed_in(params, tokens, cfg, extra_embeds=None):
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    x = logical_constraint(x, ("batch", None, None))
    if extra_embeds is not None:  # pixtral: prepend stub patch embeddings
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        x = logical_constraint(x, ("batch", None, None))
    return x


def forward(params, tokens, cfg: ArchConfig, extra_embeds=None):
    """Teacher-forced forward: final hidden states (B, S_total, d)."""
    x = _embed_in(params, tokens, cfg, extra_embeds)
    q_pos = torch.arange(x.shape[1], device=x.device)
    x = _run_blocks(params, x, cfg, q_pos, None)
    return norm(x, for_compute(params.get("final_norm")), kind=cfg.norm)


def logits_from_hidden(params, hidden, cfg: ArchConfig):
    """f32 logits over the padded vocab."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return matmul_f32(hidden, for_compute(w))


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """Cache tree for decode (stacked over super-blocks/sublayers)."""
    l = cfg.n_layers // max(cfg.moe_every, 1)
    sub = max(cfg.moe_every, 1)
    skv = min(cache_len, cfg.window) if cfg.window else cache_len
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    dt = act_dtype(cfg)
    return {
        "k": ParamSpec((l, sub, batch, skv, hkv, dh),
                       ("layers", None, "batch", "kv_seq", "kv", None),
                       dtype=dt, init="zeros"),
        "v": ParamSpec((l, sub, batch, skv, hkv, dh),
                       ("layers", None, "batch", "kv_seq", "kv", None),
                       dtype=dt, init="zeros"),
        "kv_pos": ParamSpec((l, sub, skv), ("layers", None, "kv_seq"),
                            dtype=torch.int32, init="zeros"),
        "pos": ParamSpec((l, sub), ("layers", None), dtype=torch.int32,
                         init="zeros"),
    }


def prefill(params, tokens, cfg: ArchConfig, extra_embeds=None,
            cache_len: int | None = None):
    """Forward pass that builds caches sized ``cache_len`` (>= prompt;
    defaults to the prompt length: pass headroom for decode).  Returns
    (last-position logits (B, V_pad) f32, caches)."""
    x = _embed_in(params, tokens, cfg, extra_embeds)
    b, s, _ = x.shape
    caches = empty_caches(cache_specs(cfg, b, max(cache_len or s, s)),
                          x.device)
    q_pos = torch.arange(s, device=x.device)
    x = _run_blocks(params, x, cfg, q_pos, caches)
    h_last = norm(x[:, -1], for_compute(params.get("final_norm")),
                  kind=cfg.norm)
    return logits_from_hidden(params, h_last, cfg), caches


def decode_step(params, caches, tokens, cfg: ArchConfig):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, V_pad) f32,
    caches), the caches written in place."""
    x = _embed_in(params, tokens, cfg)
    q_pos = caches["pos"][0, :1].long()  # uniform across layers
    x = _run_blocks(params, x, cfg, q_pos, caches)
    h = norm(x[:, 0], for_compute(params.get("final_norm")), kind=cfg.norm)
    return logits_from_hidden(params, h, cfg), caches
