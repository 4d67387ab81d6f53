"""Mamba-2 (SSD, state-space duality) — arXiv:2405.21060.

Attention-free LM: each layer is
    in_proj -> [z | xBC | dt];  causal conv over xBC;  SSD;  gated RMSNorm;
    out_proj
with the SSD computed by the chunked algorithm (Dao & Gu 2024 Alg. 1):
intra-chunk "attention" products plus an inter-chunk state recurrence,
here a Python loop over chunks.  Decode carries an O(1) state
(B, H, P, N) and the conv tail, updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ArchConfig
from .layers import (assign, causal_conv1d, embed, matmul_f32, norm,
                     on_batch_shards, remat)
from .params import (ParamSpec, empty_caches, for_compute, logical_constraint,
                     weights_for_compute)
from .transformer import act_dtype

__all__ = [
    "param_specs",
    "forward",
    "prefill",
    "decode_step",
    "cache_specs",
    "ssd_chunked",
    "ssd_ref",
]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(x):
    """Stable 'segment sum' for the intra-chunk decay matrix.

    x: (..., q).  Returns (..., q, q) where out[i, j] = sum_{k=j+1..i} x_k
    for i >= j, -inf otherwise.
    """
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int, h0=None):
    """Chunked SSD scan.

    Args:
      x:  (B, S, H, P) inputs (already conv'd / activated).
      dt: (B, S, H) softplus'd step sizes (> 0).
      a_log: (H,) log of -A (A = -exp(a_log) < 0).
      b, c: (B, S, G, N) input/output projections (G groups broadcast to H).
      d_skip: (H,) skip connection.
      chunk: intra-chunk length Q.
      h0: optional initial state (B, H, P, N).

    Returns: (y (B, S, H, P), h_final (B, H, P, N) f32).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    nc, q = s // chunk, chunk
    rep = h // g

    a = -torch.exp(a_log.float())
    dta = dt.float() * a  # (B, S, H)
    dtx = x.float() * dt.float()[..., None]

    def ch(t):  # (B, S, ...) -> (B, nc, q, ...)
        return t.reshape(bsz, nc, q, *t.shape[2:])

    dta_c = ch(dta)  # (B, nc, q, H)
    dtx_c = ch(dtx)  # (B, nc, q, H, P)
    b_c = ch(b.float())  # (B, nc, q, G, N)
    c_c = ch(c.float())

    # intra-chunk (the "quadratic attention" branch)
    lmat = torch.exp(_segsum(dta_c.transpose(-1, -2)))  # (B, nc, H, q, q)
    cb = torch.einsum("bzqgn,bzkgn->bzgqk", c_c, b_c)
    cb = torch.repeat_interleave(cb, rep, dim=2)  # (B, nc, H, q, q)
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", cb * lmat, dtx_c)

    # chunk states
    cum = torch.cumsum(dta_c, dim=2)  # (B, nc, q, H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    b_h = torch.repeat_interleave(b_c, rep, dim=3) if g != h else b_c
    states = torch.einsum("bzqh,bzqhn,bzqhp->bzhpn", decay_to_end, b_h,
                          dtx_c)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(torch.sum(dta_c, dim=2))  # (B, nc, H)
    carry = (h0.float() if h0 is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    h_prev = []
    for z in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, P, N)

    # off-diagonal (state -> output)
    decay_from_start = torch.exp(cum)
    c_h = torch.repeat_interleave(c_c, rep, dim=3) if g != h else c_c
    y_off = torch.einsum("bzqhn,bzhpn,bzqh->bzqhp", c_h, h_prev,
                         decay_from_start)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), carry


def ssd_ref(x, dt, a_log, b, c, d_skip, h0=None):
    """Sequential-scan oracle for ssd_chunked (tests)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    state = (h0.float() if h0 is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    b_h = torch.repeat_interleave(b, rep, dim=2).float()
    c_h = torch.repeat_interleave(c, rep, dim=2).float()
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t].float() * a)  # (B, H)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, t].float(),
                           x[:, t].float(), b_h[:, t])
        state = state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", state, c_h[:, t])
        y = y + x[:, t].float() * d_skip.float()[None, :, None]
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# Layer / model
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ArchConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.n_ssm_heads
    conv_dim = din + 2 * g * n
    l = cfg.n_layers
    la = ("layers",)
    f32 = torch.float32
    return {
        # in_proj -> [z (din) | x (din) | B (g n) | C (g n) | dt (h)]
        "in_proj": ParamSpec((l, d, 2 * din + 2 * g * n + h),
                             la + ("embed", "mlp")),
        "conv_w": ParamSpec((l, conv_dim, cfg.d_conv), la + ("mlp", None)),
        "conv_b": ParamSpec((l, conv_dim), la + ("mlp",), init="zeros"),
        "a_log": ParamSpec((l, h), la + (None,), dtype=f32, init="ones"),
        "d_skip": ParamSpec((l, h), la + (None,), dtype=f32, init="ones"),
        "dt_bias": ParamSpec((l, h), la + (None,), dtype=f32, init="zeros"),
        "norm_scale": ParamSpec((l, din), la + ("mlp",), dtype=f32,
                                init="ones"),
        "out_proj": ParamSpec((l, din, d), la + ("mlp", "embed")),
        "ln": ParamSpec((l, d), la + ("embed",), dtype=f32, init="ones"),
    }


def param_specs(cfg: ArchConfig) -> dict:
    return {
        "embed": ParamSpec((cfg.vocab_pad, cfg.d_model), ("vocab", "embed")),
        "blocks": _layer_specs(cfg),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",),
                                dtype=torch.float32, init="ones"),
    }


def _mamba_mix(x_in, p, cfg: ArchConfig, state=None, conv_state=None):
    """One mamba2 mixer.  x_in: (B, S, d).  Returns (y, new_state,
    new_conv)."""
    bsz, s, _ = x_in.shape
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    chunk = cfg.ssm_chunk

    x_in = logical_constraint(x_in, ("batch", None, None))
    z_all = torch.matmul(x_in, p["in_proj"])
    z_all = logical_constraint(z_all, ("batch", None, "mlp"))
    z = z_all[..., :din]
    xbc = z_all[..., din:din + din + 2 * g * n]
    dt_raw = z_all[..., -h:]

    xbc, new_conv = causal_conv1d(xbc, p["conv_w"], state=conv_state)
    xbc = F.silu(xbc + p["conv_b"].to(xbc.dtype))
    xs = xbc[..., :din].reshape(bsz, s, h, hd)
    b = xbc[..., din:din + g * n].reshape(bsz, s, g, n)
    c = xbc[..., din + g * n:].reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])

    if s == 1 and state is not None:
        # O(1) decode update (no chunking)
        a = -torch.exp(p["a_log"].float())
        decay = torch.exp(dt[:, 0] * a)  # (B, H)
        rep = h // g
        b_h = torch.repeat_interleave(b[:, 0], rep, dim=1).float()
        c_h = torch.repeat_interleave(c[:, 0], rep, dim=1).float()
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0], xs[:, 0].float(),
                           b_h)
        new_state = state.float() * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", new_state, c_h)
        y = y + xs[:, 0].float() * p["d_skip"][None, :, None]
        y = y[:, None].to(x_in.dtype)  # (B, 1, H, P)
    else:
        # padded steps have dt = 0: decay 1, update 0, so the final state
        # is the state after the last real step
        pad = (-s) % chunk

        def ssd(xs, dt, b, c, h0, a_log, d_skip):
            if pad:
                xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
                dt = F.pad(dt, (0, 0, 0, pad))
                b = F.pad(b, (0, 0, 0, 0, 0, pad))
                c = F.pad(c, (0, 0, 0, 0, 0, pad))
            y, st = ssd_chunked(xs, dt, a_log, b, c, d_skip, chunk, h0=h0)
            return y[:, :s], st

        y, new_state = on_batch_shards(ssd, (xs, dt, b, c, state),
                                       (p["a_log"], p["d_skip"]))

    y = y.reshape(bsz, s, din)
    y = norm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"],
             kind="rmsnorm")
    out = torch.matmul(y, p["out_proj"])
    return out, new_state, new_conv


def _block(x, p, cfg: ArchConfig):
    """One training-forward layer (no cache)."""
    p = weights_for_compute(p)
    y, _, _ = _mamba_mix(norm(x, p["ln"], kind="rmsnorm"), p, cfg)
    return x + y


def _run(params, x, cfg: ArchConfig, caches=None):
    """Every layer in turn (each rematted under ``cfg.remat`` when no
    cache is given); ``caches`` are written in place."""
    per = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(cfg.n_layers):
        p = {k: per[k][i] for k in per}
        if caches is None:
            x = remat(_block, x, p, cfg, on=cfg.remat)
            continue
        p = weights_for_compute(p)
        h = norm(x, p["ln"], kind="rmsnorm")
        y, ns, nc = _mamba_mix(h, p, cfg, state=caches["ssm"][i],
                               conv_state=caches["conv"][i])
        assign(caches["ssm"][i], ns)
        assign(caches["conv"][i], nc)
        x = x + y
    if caches is not None:
        caches["pos"] += x.shape[1]
    return x


def _embed(params, tokens, cfg):
    x = embed(params["embed"], tokens).to(act_dtype(cfg))
    return logical_constraint(x, ("batch", None, None))


def forward(params, tokens, cfg: ArchConfig):
    x = _run(params, _embed(params, tokens, cfg), cfg, None)
    return norm(x, for_compute(params["final_norm"]), kind="rmsnorm")


def _logits(params, hidden):
    return matmul_f32(hidden, for_compute(params["embed"].T))


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int = 0) -> dict:
    l = cfg.n_layers
    h, hd, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": ParamSpec((l, batch, h, hd, n),
                         ("layers", "batch", None, None, "state"),
                         dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((l, batch, cfg.d_conv - 1, conv_dim),
                          ("layers", "batch", None, "mlp"),
                          dtype=act_dtype(cfg), init="zeros"),
        "pos": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def prefill(params, tokens, cfg: ArchConfig, cache_len: int | None = None):
    """Run the chunked scan and keep the final states as the cache
    (``cache_len`` is irrelevant: the state is O(1))."""
    x = _embed(params, tokens, cfg)
    caches = empty_caches(cache_specs(cfg, tokens.shape[0]), x.device)
    x = _run(params, x, cfg, caches)
    h_last = norm(x[:, -1], for_compute(params["final_norm"]),
                  kind="rmsnorm")
    return _logits(params, h_last), caches


def decode_step(params, caches, tokens, cfg: ArchConfig):
    x = _run(params, _embed(params, tokens, cfg), cfg, caches)
    h = norm(x[:, 0], for_compute(params["final_norm"]), kind="rmsnorm")
    return _logits(params, h), caches
