"""Train/serve step builders for the training loop.

``make_train_step`` assembles the JAX package's step on one device:
  gradients of ``loss_fn`` (``torch.autograd.grad``; microbatches split
  on dim 0 and accumulated in ``cfg.grad_accum_dtype``)
  -> global-norm clip -> optional error-feedback grad compression
  -> optimizer update.

State is a plain dict {"params", "opt", ["resid"]}; ``state_specs`` gives
it as a ParamSpec tree (``abstract_params`` of it: the restore target,
no memory).  The step is functional: it returns a new state and never
writes into the one it was given.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.api import Model
from ..models.params import ParamSpec, tree_leaves, tree_map
from .compression import CompressionConfig, compress_grads, init_residual
from .optimizer import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
    opt_state_specs,
)

__all__ = ["make_train_step", "make_serve_step", "make_prefill",
           "state_specs", "init_state"]


def state_specs(model: Model, optimizer: Optimizer,
                compression: CompressionConfig | None = None) -> dict:
    """ParamSpec tree of every leaf the train step reads and writes."""
    p_specs = model.param_specs()
    out = {"params": p_specs, "opt": opt_state_specs(optimizer.name, p_specs)}
    if compression and compression.kind != "none":
        out["resid"] = tree_map(
            lambda s: ParamSpec(s.shape, s.axes, dtype=torch.float32,
                                init="zeros"), p_specs)
    return out


def init_state(model: Model, optimizer: Optimizer, seed: int = 0,
               compression: CompressionConfig | None = None,
               device="cuda") -> dict:
    """Fresh parameters (``model.init(seed, device)``), optimizer state
    and, with compression, a zero residual."""
    params = model.init(seed, device=resolve_device(device))
    state = {"params": params, "opt": optimizer.init(params)}
    if compression and compression.kind != "none":
        state["resid"] = init_residual(params, compression)
    return state


def _split_microbatches(batch: dict, n_mb: int) -> list:
    """``n_mb`` batches cut from dim 0 of every input."""
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_mb:
            raise ValueError(f"{k}: batch {b} % microbatches {n_mb} != 0")
    return [{k: x[i * (x.shape[0] // n_mb):(i + 1) * (x.shape[0] // n_mb)]
             for k, x in batch.items()} for i in range(n_mb)]


def _value_and_grad(model: Model, params, batch):
    """(loss, grads in each parameter's dtype).  A parameter the loss does
    not reach gets a zero gradient, as under ``jax.grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = model.loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, optimizer: Optimizer,
                    n_microbatches: int | None = None,
                    clip_norm: float = 1.0,
                    compression: CompressionConfig | None = None):
    """Returns train_step(state, batch) -> (new state, metrics); metrics
    ``loss``, ``grad_norm`` and ``step`` are tensors on the device."""
    n_mb = n_microbatches or model.cfg.n_microbatches
    comp = compression or CompressionConfig("none")
    acc_dt = (torch.bfloat16 if model.cfg.grad_accum_dtype == "bfloat16"
              else torch.float32)

    def grads_of(params, batch):
        if n_mb == 1:
            loss, grads = _value_and_grad(model, params, batch)
            return loss, tree_map(lambda g: g.float(), grads)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                               device=p.device), params)
        for mb in _split_microbatches(batch, n_mb):
            loss, grads = _value_and_grad(model, params, mb)
            g_sum = tree_map(lambda a, g: a + g.to(acc_dt), g_sum, grads)
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / n_mb
        return loss_sum * inv, tree_map(lambda g: g.float() * inv, g_sum)

    @torch.no_grad()
    def train_step(state, batch):
        params = state["params"]
        loss, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_state = {}
        if comp.kind != "none":
            grads, new_state["resid"] = compress_grads(
                grads, state["resid"], comp)
        updates, new_opt = optimizer.update(grads, state["opt"], params)
        del grads
        new_state["params"] = apply_updates(params, updates)
        new_state["opt"] = new_opt
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt["step"]}
        return new_state, metrics

    return train_step


def make_serve_step(model: Model):
    """decode: (params, caches, tokens (B, 1)) -> (next_tokens (B, 1)
    int32, caches); the caches are written in place."""

    def serve_step(params, caches, tokens):
        logits, caches = model.decode_step(params, caches, tokens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return serve_step


def make_prefill(model: Model):
    """prefill: (params, batch) -> (next_tokens (B, 1) int32, caches)."""

    def prefill(params, batch):
        logits, caches = model.prefill(params, batch)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return prefill
