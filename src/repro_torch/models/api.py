"""Unified model API: ``build_model(cfg)`` -> :class:`Model`.

One object per architecture family exposing the same surface:

  param_specs()                 ParamSpec tree (drives init / count)
  init(seed, device)            real parameter tree on the device
  loss_fn(params, batch)        mean next-token CE (chunked over positions)
  forward(params, batch)        final hidden states
  prefill(params, batch)        (last_logits, caches)
  decode_step(params, caches, tokens)
  cache_specs(batch, cache_len) ParamSpec tree for the decode cache
  init_caches(batch, cache_len, device)
  input_specs(shape)            {name: (shape, dtype)} of a batch
  make_batch(seed, shape, device) synthetic concrete batch

Batch layouts:
  transformer: {"tokens": (B, S+1) i32}
  pixtral:     {"tokens": (B, S-n_patches+1) i32, "patches": (B, n_patches, d)}
  mamba2 / rglru_hybrid: {"tokens": (B, S+1) i32}
  encdec:      {"tokens": (B, S+1) i32, "frames": (B, n_frames, d)}

The serving methods (``forward``, ``prefill``, ``decode_step``,
``init_caches``) run under ``torch.inference_mode()``; decode caches are
written in place.  ``init`` builds the parameters under
``torch.no_grad()``, so they can enter autograd, and ``loss_fn`` records
a gradient whenever its inputs ask for one (``repro_torch.train``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import ArchConfig, ShapeConfig
from ..device import resolve_device
from . import mamba2, rglru, transformer, whisper
from .layers import matmul_f32, remat
from .params import (abstract_params, cast_specs, empty_caches, for_compute,
                     init_params, logical_constraint)
from .transformer import act_dtype

__all__ = ["Model", "build_model", "chunked_ce_loss"]

_FAMILY = {"mamba2": mamba2, "rglru_hybrid": rglru, "encdec": whisper}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def chunked_ce_loss(params, hidden, labels, cfg: ArchConfig,
                    logits_fn: Callable | None = None):
    """Mean CE over valid (label >= 0) tokens, computed ``ce_chunk``
    positions at a time so the full (B, S, V) logits never exist.
    Vocab-padding logits are masked out.  Under autograd each chunk is
    rematted, as the reference's ``@jax.checkpoint chunk``: its f32
    logits are recomputed in the backward, not kept."""
    if logits_fn is None:
        def logits_fn(p, h):
            w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
            return matmul_f32(h, for_compute(w))

    b, s, _ = hidden.shape
    c = min(cfg.ce_chunk, s)
    while s % c:
        c //= 2

    def chunk(h, lab):
        h = logical_constraint(h, ("batch", None, None))
        logits = logits_fn(params, h)  # (B, c, V_pad) f32
        logits = logical_constraint(logits, ("batch", None, "vocab"))
        viota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(viota < cfg.vocab, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.sum(torch.where(viota == lab[..., None].long(), logits,
                                     0.0), dim=-1)
        return torch.sum((lse - gold) * (lab >= 0).float())

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        lab = labels[:, i:i + c]
        tot = tot + remat(chunk, hidden[:, i:i + c], lab)
        cnt = cnt + torch.sum((lab >= 0).float())
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def _mod(self):
        return _FAMILY.get(self.cfg.family, transformer)

    # ---- parameters -------------------------------------------------------
    def param_specs(self):
        specs = self._mod.param_specs(self.cfg)
        if self.cfg.dtype == "float32":
            specs = cast_specs(specs, torch.float32)
        return specs

    def init(self, seed: int = 0, device="cuda"):
        """Parameters on ``device``, drawn under ``torch.no_grad()``
        (plain tensors, not inference tensors: training takes their
        gradient)."""
        return init_params(self.param_specs(), seed, device)

    def abstract_params(self):
        return abstract_params(self.param_specs())

    # ---- forward / loss ---------------------------------------------------
    def _hidden(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"][:, :-1]
        if cfg.family == "encdec":
            return whisper.forward(params, tokens, batch["frames"], cfg)
        if cfg.family == "transformer":
            return transformer.forward(params, tokens, cfg,
                                       extra_embeds=batch.get("patches"))
        return self._mod.forward(params, tokens, cfg)

    @torch.inference_mode()
    def forward(self, params, batch):
        return self._hidden(params, batch)

    def loss_fn(self, params, batch):
        """Mean next-token CE; differentiable in ``params``."""
        hidden = self._hidden(params, batch)
        labels = batch["tokens"][:, 1:]
        if "patches" in batch:
            # hidden covers [patches; text]; only text positions have labels
            npatch = batch["patches"].shape[1]
            pad = torch.full((labels.shape[0], npatch), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        return chunked_ce_loss(params, hidden, labels, self.cfg)

    # ---- serving ----------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int | None = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "mamba2":
            return mamba2.prefill(params, tokens, cfg)
        if cfg.family == "rglru_hybrid":
            return rglru.prefill(params, tokens, cfg, cache_len=cache_len)
        if cfg.family == "encdec":
            return whisper.prefill(params, tokens, batch["frames"], cfg,
                                   cache_len=cache_len)
        return transformer.prefill(params, tokens, cfg,
                                   extra_embeds=batch.get("patches"),
                                   cache_len=cache_len)

    @torch.inference_mode()
    def decode_step(self, params, caches, tokens):
        """(logits (B, V_pad) f32, caches); ``caches`` is written in place
        and returned."""
        return self._mod.decode_step(params, caches, tokens, self.cfg)

    def cache_specs(self, batch: int, cache_len: int):
        specs = self._mod.cache_specs(self.cfg, batch, cache_len)
        if self.cfg.dtype == "float32":
            specs = cast_specs(specs, torch.float32)
        return specs

    def abstract_caches(self, batch: int, cache_len: int):
        """The cache tree as meta tensors (shapes and dtypes, no storage)."""
        return abstract_params(self.cache_specs(batch, cache_len))

    @torch.inference_mode()
    def init_caches(self, batch: int, cache_len: int, device="cuda"):
        """Empty caches: zeros, with every ``kv_pos`` slot at -1."""
        return empty_caches(self.cache_specs(batch, cache_len),
                            resolve_device(device))

    # ---- inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """{name: (shape, dtype)} of a batch for ``shape``'s kind."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt_act = act_dtype(cfg)
        if shape.kind == "decode":  # one new token against a cache
            return {"tokens": ((b, 1), torch.int32)}
        out = {}
        s_tok = s
        if cfg.family == "transformer" and cfg.n_patches:
            s_tok = s - cfg.n_patches
            if s_tok <= 0:
                raise ValueError(
                    f"{cfg.name}: seq_len {s} leaves no text positions after "
                    f"{cfg.n_patches} patch positions")
            out["patches"] = ((b, cfg.n_patches, cfg.d_model), dt_act)
        if cfg.family == "encdec":
            out["frames"] = ((b, cfg.n_frames, cfg.d_model), dt_act)
        extra = 1 if shape.kind == "train" else 0
        out["tokens"] = ((b, s_tok + extra), torch.int32)
        return out

    def make_batch(self, seed: int, shape: ShapeConfig, device="cuda") -> dict:
        """Tokens uniform in [0, vocab); embeddings f32 normals x 0.02 cast
        to the activation dtype.  Drawn from a generator on ``device``
        seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = {}
        for k, (shp, dt) in self.input_specs(shape).items():
            if dt == torch.int32:
                out[k] = torch.randint(0, self.cfg.vocab, shp, generator=gen,
                                       device=dev, dtype=torch.int32)
            else:
                out[k] = (torch.randn(shp, generator=gen, device=dev)
                          .to(dt) * 0.02)
        return out


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)

