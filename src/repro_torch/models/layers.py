"""Shared model layers: norms, RoPE, chunked GQA/SWA attention, MLP, MoE.

The JAX package's ``models/layers.py`` in plain PyTorch, function for
function:

  * Attention is query-chunked with masking from absolute positions, so
    the same code serves forward (causal), SWA, prefill and decode (Sq=1
    against a cache).  Scores for one chunk are (q_chunk x Skv).
  * MoE ``moe`` is the sort-free capacity scatter (position-in-expert by
    cumsum, ``index_put_(accumulate=True)`` into (E, C, d) buffers);
    ``moe_grouped`` is the group-local one-hot dispatch.
  * Where the reference asks for f32 results from bf16 operands
    (``preferred_element_type=f32``), :func:`matmul_f32` asks cuBLAS for
    an f32 output (``out_dtype``), with JAX's transpose rule as its
    gradient; the other products return the operand dtype, as
    ``jnp.matmul`` does.
  * :func:`remat` runs a layer under activation checkpointing (the
    reference's ``jax.checkpoint``) when a gradient is being recorded.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.checkpoint import checkpoint

from .params import contiguous_strides, logical_constraint

__all__ = [
    "NEG_INF",
    "assign",
    "attention",
    "embed",
    "causal_conv1d",
    "gelu",
    "matmul_f32",
    "merge_heads",
    "mlp",
    "moe",
    "moe_grouped",
    "norm",
    "on_batch_shards",
    "remat",
    "rope",
    "split_heads",
    "write_slot",
]

NEG_INF = -1e30


def _bf16_product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands on the card, f32 accumulation and output (cuBLAS
    ``out_dtype``); ``b`` 2-D or batched like ``a``."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


# DTensor sharding rules (one mesh dim; DTensor expands them over the
# mesh).  Each entry is ([outputs], [tensor inputs]).
@register_sharding(torch.ops.aten.mm.dtype)
def _mm_dtype_sharding(a, b, out_dtype):
    """``aten.mm``'s strategies for the f32-output product, which DTensor
    has none for: replicated, rows of ``a``, columns of ``b``, or the
    contraction split into a partial sum."""
    return [([Replicate()], [Replicate(), Replicate()]),
            ([Shard(0)], [Shard(0), Replicate()]),
            ([Shard(1)], [Replicate(), Shard(1)]),
            ([Partial()], [Shard(1), Shard(0)])]


@register_sharding(torch.ops.aten.bmm.dtype)
def _bmm_dtype_sharding(a, b, out_dtype):
    """``aten.bmm``'s strategies for the f32-output batched product."""
    return [([Replicate()], [Replicate(), Replicate()]),
            ([Shard(0)], [Shard(0), Shard(0)]),
            ([Shard(1)], [Shard(1), Replicate()]),
            ([Shard(2)], [Replicate(), Shard(2)]),
            ([Partial()], [Shard(2), Shard(1)])]


@register_sharding(torch.ops.aten.topk.default)
def _topk_sharding(x, k, dim=-1, largest=True, sorted=True):
    """DTensor's own ``topk`` rule, registered again so that ``k`` is part
    of its cache key (DTensor keys it from ``dim`` on, and a second call
    with another ``k`` reused the first one's output shape)."""
    d = dim % len(x.shape)
    out = [([Replicate()] * 2, [Replicate()])]
    out += [([Shard(i)] * 2, [Shard(i)]) for i in range(len(x.shape))
            if i != d]
    return out


class _MatmulF32(torch.autograd.Function):
    """:func:`_bf16_product_f32` with JAX's transpose rule for
    ``dot_general(preferred_element_type=f32)``: each operand's cotangent
    is the f32 product of the f32 cotangent with the other operand, cast
    to that operand's dtype.  Only the bf16 operands are saved; the f32
    copy of the other operand lives for one product of the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bf16_product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().mT).sum_to_size(a.shape)
            ga = _summed(ga, a).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = torch.matmul(a.reshape(-1, a.shape[-1]).float().T,
                                  g.reshape(-1, g.shape[-1]))
            else:
                gb = torch.matmul(a.float().mT, g).sum_to_size(b.shape)
            gb = _summed(gb, b).to(b.dtype)
        return ga, gb


def _summed(t, like):
    """An f32 cotangent whose DTensor is a partial sum, reduced into the
    placements of its operand ``like`` before the cast to ``like``'s
    dtype: the cast rounds once, after the whole sum, as on one device."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, like.placements)
    return t


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` with an f32 result.

    f32 operands multiply as they are.  Mixed dtypes promote to f32 (as
    in JAX).  bf16 operands on the card keep bf16 inputs and accumulate
    into an f32 output (``torch.mm``/``torch.bmm`` with ``out_dtype``), so
    no f32 copy of a weight is made; PyTorch has no derivative for that
    product, so :class:`_MatmulF32` supplies JAX's.  The CPU build has no
    such kernel, and there the operands are upcast (autograd
    differentiates the upcast product as it is).
    """
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype != b.dtype or not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    return _MatmulF32.apply(a, b)


def remat(fn, *args, on: bool = True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``on`` and a gradient is being recorded: its activations are
    dropped after the forward and recomputed in the backward, as the
    reference's ``jax.checkpoint``.  The values are the same either
    way."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def assign(buf: torch.Tensor, value: torch.Tensor) -> None:
    """``buf.copy_(value)``; a DTensor ``value`` first takes ``buf``'s
    placements, so the copy is local on every rank (an in-place op whose
    rule wants other placements for ``buf`` would relabel ``buf``'s
    placements without moving its data)."""
    if isinstance(buf, DTensor) and isinstance(value, DTensor) and \
            tuple(value.placements) != tuple(buf.placements):
        value = value.redistribute(buf.device_mesh, buf.placements)
    buf.copy_(value)


def write_slot(buf: torch.Tensor, dim: int, slot: torch.Tensor,
               value: torch.Tensor) -> None:
    """``buf.index_copy_(dim, slot, value)`` for one slot (``slot``: a
    1-element index, ``value``: size 1 in ``dim``).  A DTensor ``buf`` is
    written by a mask over ``dim`` (its slot may lie on any rank's
    shard), through :func:`assign`."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(dim, slot, value)
        return
    shape = [1] * buf.dim()
    shape[dim] = buf.shape[dim]
    hit = (torch.arange(buf.shape[dim], device=slot.device) == slot)
    assign(buf, torch.where(hit.reshape(shape), value.to(buf.dtype), buf))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the rows of an embedding table.  On a mesh the
    table is gathered whole and each rank looks up its own rows of tokens
    (:func:`on_batch_shards`): DTensor's lookup rules do not cover a table
    or a batch split over two mesh axes in every torch version, and a
    split table's gradient would be a masked partial sum that the logits'
    gradient of a tied table cannot be added to."""
    return on_batch_shards(lambda t, tab: tab[t.long()], (tokens,), (table,))


def split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    """(B, S, n_heads * d_head) -> (B, S, n_heads, d_head).  On a mesh the
    last dim stays split only on the mesh dims whose size divides
    ``n_heads`` (the reference pins heads so), so the reshape splits whole
    heads; a split that divides only ``n_heads * d_head`` is gathered
    first."""
    b, s = x.shape[0], x.shape[1]
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        placements = tuple(
            Replicate() if pl == Shard(2) and n_heads % mesh.size(i) else pl
            for i, pl in enumerate(x.placements))
        if placements != tuple(x.placements):
            x = x.redistribute(mesh, placements)
    return x.reshape(b, s, n_heads, d_head)


class _MergeHeads(torch.autograd.Function):
    """The merge of :func:`merge_heads`, whose gradient is split back into
    heads by :func:`split_heads`."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[2:]
        return x.reshape(x.shape[0], x.shape[1], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, *ctx.heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, n_heads, d_head) -> (B, S, n_heads * d_head).  On a mesh the
    gradient comes back split on its last dim as the output projection
    splits it; it is split into heads as :func:`split_heads` splits (torch
    2.11's view rules refuse to split a dim sharded over a mesh dim that
    does not divide ``n_heads``, as llama4's 40 heads on 16)."""
    return _MergeHeads.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm(x, scale=None, bias=None, kind: str = "rmsnorm", eps: float = 1e-6):
    """rmsnorm | layernorm | nonparametric (OLMo: LN without params)."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:  # layernorm / nonparametric
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding.  x: (..., S, H, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq  # (..., S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + causal/SWA masks + q-chunking)
# ---------------------------------------------------------------------------


def _attn_block(q, k, v, q_pos, kv_pos, kv_valid, causal, window):
    """q: (B, Sq, Hkv, rep, D); k/v: (B, Skv, Hkv, D)."""
    b, sq, hkv, rep, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    # scores (B, Hkv, rep, Sq, Skv) = einsum("bqhrd,bkhd->bhrqk") in f32
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, hkv, rep * sq, d)
    scores = matmul_f32(qh, k.permute(0, 2, 3, 1))
    scores = scores.reshape(b, hkv, rep, sq, skv) * scale
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    if kv_valid is not None:  # (B, Skv) cache-slot validity
        mask = (mask[None] & kv_valid[:, None, :])[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.reshape(b, hkv, rep * sq, skv),
                       v.permute(0, 2, 1, 3))  # (B, Hkv, rep*Sq, D)
    return out.reshape(b, hkv, rep, sq, d).permute(0, 3, 1, 2, 4)


def attention(
    q,
    k,
    v,
    q_pos,
    kv_pos,
    kv_valid=None,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
):
    """Chunked multi-query attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.
    q_pos: (Sq,), kv_pos: (Skv,) absolute positions; kv_valid: (B, Skv) or
    (1, Skv).
    Queries are cut into chunks of ``q_chunk``; the last chunk is padded
    with rows at position -1 (masked everywhere), which are sliced off.
    """
    if isinstance(q, DTensor):
        return _attention_on_mesh(q, k, v, q_pos, kv_pos, kv_valid, causal,
                                  window, q_chunk)
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    if sq <= q_chunk:
        out = _attn_block(qg, k, v, q_pos, kv_pos, kv_valid, causal, window)
        return out.reshape(b, sq, hq, d)
    pad = (-sq) % q_chunk
    if pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    outs = [
        _attn_block(qg[:, i:i + q_chunk], k, v, q_pos[i:i + q_chunk], kv_pos,
                    kv_valid, causal, window)
        for i in range(0, sq + pad, q_chunk)
    ]
    return torch.cat(outs, dim=1).reshape(b, sq + pad, hq, d)[:, :sq]


def _local(t, mesh, placements, grads=None):
    """A DTensor's local tensor after a redistribute to ``placements``
    (``grads``: the placements its gradient takes); plain tensors, None
    and dicts of them pass through (dicts element by element)."""
    if isinstance(t, dict):
        return {k: _local(v, mesh, placements, grads) for k, v in t.items()}
    if not isinstance(t, DTensor):
        return t
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local(grad_placements=grads)


def _attention_on_mesh(q, k, v, q_pos, kv_pos, kv_valid, causal, window,
                       q_chunk):
    """:func:`attention` of DTensors, run on each rank's shards.

    Attention is independent across sequences and kv-head groups, so each
    mesh dim keeps q's split of the batch (dim 0) or of the heads (dim 2,
    when the kv heads divide as the q heads do) and gives k and v (and
    ``kv_valid``) the same split; any other split (of the sequence, or of
    the head dim) is gathered first.  The positions are gathered whole.
    The local products are :func:`attention`'s own, and the result has
    q's placements."""
    mesh = q.device_mesh
    hkv = k.shape[2]
    qp = []
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl == Shard(0) or (pl == Shard(2) and hkv % n == 0):
            qp.append(pl)
        else:
            qp.append(Replicate())
    kvp = tuple(qp)
    rep_all = (Replicate(),) * mesh.ndim
    valid_p = rep_all if kv_valid is None or kv_valid.shape[0] == 1 else \
        tuple(pl if pl == Shard(0) else Replicate() for pl in qp)

    out = attention(_local(q, mesh, kvp), _local(k, mesh, kvp),
                    _local(v, mesh, kvp), _local(q_pos, mesh, rep_all),
                    _local(kv_pos, mesh, rep_all),
                    _local(kv_valid, mesh, valid_p), causal=causal,
                    window=window, q_chunk=q_chunk)
    return DTensor.from_local(out.contiguous(), mesh, kvp, run_check=False,
                              shape=q.shape,
                              stride=contiguous_strides(q.shape))


def on_batch_shards(fn, batched: tuple, shared: tuple = ()):
    """``fn(*batched, *shared)`` run on each rank's rows when the first
    batched input is a DTensor; ``fn(*batched, *shared)`` as it is
    otherwise.

    Every batched input (dim 0 the batch; None passes through) keeps the
    first one's split of dim 0 and is gathered on its other dims; the
    shared inputs (tensors or dicts of them) are gathered whole; each
    output (dim 0 the batch) comes back with that split.  The recurrences
    (the SSD chunk scan, the RG-LRU scan) are independent across
    sequences, and DTensor's rules for their reshapes differ between
    torch versions."""
    x = batched[0]
    if not isinstance(x, DTensor):
        return fn(*batched, *shared)
    mesh = x.device_mesh
    rows = tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)
    whole = (Replicate(),) * mesh.ndim
    # a shared input's gradient from one rank's rows is a partial sum over
    # the ranks that split the rows
    summed = tuple(Partial() if pl == Shard(0) else Replicate() for pl in rows)

    def wrap(o):
        shape = (x.shape[0],) + tuple(o.shape[1:])
        return DTensor.from_local(o.contiguous(), mesh, rows, run_check=False,
                                  shape=shape,
                                  stride=contiguous_strides(shape))

    out = fn(*(_local(t, mesh, rows) for t in batched),
             *(_local(t, mesh, whole, summed) for t in shared))
    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def mlp(x, p, act: str = "silu_glu"):
    """Dense FFN.  p: dict with wi_gate/wi_up/wo (glu) or wi/wo (gelu)."""
    if act == "silu_glu":
        g = torch.matmul(x, p["wi_gate"])
        u = torch.matmul(x, p["wi_up"])
        return torch.matmul(F.silu(g) * u, p["wo"])
    return torch.matmul(gelu(torch.matmul(x, p["wi"])), p["wo"])


def _one_hot(idx, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over ``n`` classes, by comparison
    (``F.one_hot`` checks its range with an assert that DTensor has no
    rule for under inference mode)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _route(xt, router, top_k: int):
    """Router softmax (f32) and its renormalised top-k gates."""
    probs = torch.softmax(matmul_f32(xt, router), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _expert_ffn(buf, p, dtype):
    """Grouped expert FFN on (E, C, d) -> f32 (E, C, d)."""
    g = matmul_f32(buf, p["wi_gate"])
    u = matmul_f32(buf, p["wi_up"])
    h = (F.silu(g) * u).to(dtype)
    return matmul_f32(h, p["wo"])


def moe(x, p, n_experts: int, top_k: int, capacity_factor: float = 1.25):
    """Top-k MoE with capacity-bounded scatter dispatch.

    x: (B, S, d) -> ((B, S, d), router probs (T, E)).  p: router (d, E),
    wi_gate/wi_up (E, d, f), wo (E, f, d).  A token past its expert's
    capacity is dropped: it adds 0 into slot ``cap - 1``.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = _route(xt, p["router"], top_k)

    cap = max(int(capacity_factor * top_k * t / n_experts), 4)
    buf = torch.zeros((n_experts, cap, d), dtype=x.dtype, device=x.device)
    slot_of = []
    prev_total = None
    for kk in range(top_k):
        e = gate_idx[:, kk]  # (T,)
        onehot = _one_hot(e, n_experts)  # (T, E)
        pos_all = torch.cumsum(onehot, dim=0) - 1
        pos = pos_all.gather(1, e[:, None])[:, 0]
        # offset by tokens already scattered in earlier k-slots
        if prev_total is not None:
            pos = pos + prev_total[e]
            prev_total = prev_total + onehot.sum(dim=0)
        else:
            prev_total = onehot.sum(dim=0)
        keep = pos < cap
        pos_c = torch.where(keep, pos, cap - 1).long()
        buf.index_put_((e, pos_c), torch.where(keep[:, None], xt, 0).to(
            x.dtype), accumulate=True)
        slot_of.append((e, pos_c, keep))

    out_buf = _expert_ffn(buf, p, x.dtype)
    yt = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for kk in range(top_k):
        e, pos_c, keep = slot_of[kk]
        w = gate_vals[:, kk] * keep
        yt = yt + w[:, None] * out_buf[e, pos_c]
    return yt.to(x.dtype).reshape(b, s, d), probs


def moe_grouped(x, p, n_experts: int, top_k: int,
                capacity_factor: float = 1.25, group_size: int = 512,
                group_chunk: int = 1):
    """Top-k MoE with group-local one-hot dispatch (GShard-style).

    Tokens are split into groups of ``group_size`` (halved until it
    divides the token count); dispatch and combine are one-hot products
    within each group over the (E * cap) slot space, accumulated per
    k-slot.  Groups run ``group_chunk`` at a time (a Python loop where the
    reference scans).  x: (B, S, d) -> ((B, S, d), router probs (T, E)).
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = _route(xt, p["router"], top_k)

    gs = min(group_size, t)
    while t % gs:
        gs //= 2
    ng = t // gs
    cap = max(int(capacity_factor * top_k * gs / n_experts), 4)

    # on a mesh the routing tensors keep the groups split as the tokens are
    # (DTensor may otherwise split a dim the reshapes below merge)
    e_g = logical_constraint(gate_idx.reshape(ng, gs, top_k),
                             ("batch", None, None))
    w_g = logical_constraint(gate_vals.reshape(ng, gs, top_k).float(),
                             ("batch", None, None))
    # rank of each (token, slot) within its expert, per group, slot-major
    onehot_i = _one_hot(e_g, n_experts)  # (ng, gs, k, E)
    flat = onehot_i.permute(0, 2, 1, 3).reshape(ng, top_k * gs, n_experts)
    pos_flat = torch.cumsum(flat, dim=1) - 1
    pos = pos_flat.reshape(ng, top_k, gs, n_experts).permute(0, 2, 1, 3)
    pos = torch.sum(pos * onehot_i, dim=-1)  # (ng, gs, k)
    keep = pos < cap
    w_g = w_g * keep  # dropped tokens contribute nothing

    ec = n_experts * cap
    xg = logical_constraint(xt.reshape(ng, gs, d), ("batch", None, None))
    gc = (ng if group_chunk <= 1 else
          max(g for g in range(1, min(group_chunk, ng) + 1) if ng % g == 0))
    iota = torch.arange(ec, device=x.device).reshape(1, 1, ec)
    ys = []
    for c0 in range(0, ng, gc):
        sl = slice(c0, c0 + gc)
        e_c, w_c, keep_c, pos_c, x_c = (e_g[sl], w_g[sl], keep[sl],
                                        pos[sl], xg[sl])
        disp = torch.zeros((gc, gs, ec), dtype=x.dtype, device=x.device)
        comb = torch.zeros((gc, gs, ec), dtype=x.dtype, device=x.device)
        for kk in range(top_k):
            slot = torch.where(keep_c[..., kk],
                               e_c[..., kk] * cap + pos_c[..., kk], ec)
            hit = (slot[..., None] == iota).to(x.dtype)  # (gc, gs, ec)
            disp = disp + hit
            comb = comb + w_c[..., kk:kk + 1].to(x.dtype) * hit
        disp = logical_constraint(disp.reshape(gc, gs, n_experts, cap),
                                  ("batch", None, "experts", None))
        comb = logical_constraint(comb.reshape(gc, gs, n_experts, cap),
                                  ("batch", None, "experts", None))
        # buf (gc, E, cap, d) = einsum("gsec,gsd->gecd", disp, x_c), f32 acc
        buf = matmul_f32(disp.reshape(gc, gs, ec).transpose(1, 2),
                         x_c).to(x.dtype)
        buf = logical_constraint(buf.reshape(gc, n_experts, cap, d),
                                 ("batch", "experts", None, None))
        # expert FFN over (E, gc*cap, d)
        eb = buf.permute(1, 0, 2, 3).reshape(n_experts, gc * cap, d)
        out_buf = _expert_ffn(eb, p, x.dtype)  # (E, gc*cap, d) f32
        out_buf = out_buf.reshape(n_experts, gc, cap, d).permute(1, 0, 2, 3)
        # y (gc, gs, d) = einsum("gsec,gecd->gsd", comb, out_buf) in f32
        y_c = torch.matmul(comb.reshape(gc, gs, ec).float(),
                           out_buf.reshape(gc, ec, d))
        ys.append(y_c.to(x.dtype))
    yt = torch.cat(ys, dim=0)
    return yt.reshape(b, s, d), probs


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, K).

    If ``state`` is given ((B, K-1, C), decode path with S small), the
    conv runs over [state; x] and the new state is returned.
    """
    k = w.shape[1]
    if state is not None:
        xin = torch.cat([state, x], dim=1)
        new_state = xin[:, -(k - 1):, :] if k > 1 else state
    else:
        # zeros before x, written as a cat (F.pad of a DTensor loses its
        # mesh dims in some torch versions); the same values as F.pad
        xin = torch.cat([torch.zeros_like(x[:, :k - 1]), x], dim=1)
        new_state = xin[:, -(k - 1):, :] if k > 1 else None
    s_out = x.shape[1]
    y = torch.zeros_like(x, dtype=torch.float32)
    for tap in range(k):
        y = y + xin[:, tap:tap + s_out, :].float() * w[:, tap].float()
    return y.to(x.dtype), new_state
