"""Train/serve step builders for the training loop and the dry run.

``make_train_step`` assembles the JAX package's step:
  gradients of ``loss_fn`` (``torch.autograd.grad``; microbatches split
  on dim 0 and accumulated in ``cfg.grad_accum_dtype``)
  -> global-norm clip -> optional error-feedback grad compression
  -> optimizer update.

State is a plain dict {"params", "opt", ["resid"]}; ``state_specs`` gives
it as a ParamSpec tree (``abstract_params`` of it: the restore target,
no memory; ``launch.mesh.state_shardings`` of it: its layout on a mesh).
The step is functional: it returns a new state and never writes into the
one it was given.

On one device the state is plain tensors.  On a mesh it is DTensors
(``NamedSharding.place``) and DTensor's sharding propagation does what
XLA's partitioner does for the reference: the step runs with the state's
mesh active (``logical_constraint`` pins the activations) and plain
tensors made inside the model treated as replicated; each gradient is
redistributed to its parameter's placements (a reduce-scatter of the
partial sums), and every leaf of the new state comes back with the
placements of the leaf it replaces (the reference's ``in_shardings ==
out_shardings``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..device import resolve_device
from ..models.api import Model
from ..models.params import (
    ParamSpec,
    _ambient_mesh,
    contiguous_strides,
    tree_leaves,
    tree_map,
    use_mesh,
)
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


def mesh_of(tree):
    """The DeviceMesh of the first DTensor leaf of ``tree`` (None: a
    plain-tensor tree)."""
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


@contextlib.contextmanager
def on_mesh(mesh):
    """The body on ``mesh``: the mesh made ambient (unless one is) and
    plain tensors mixed with DTensors taken as replicated.  No-op for
    ``mesh=None``."""
    if mesh is None:
        yield
        return
    ambient = (use_mesh(mesh) if _ambient_mesh() is None
               else contextlib.nullcontext())
    with ambient, implicit_replication():
        yield


def _rows(x, i: int, n_mb: int):
    """Microbatch ``i`` of ``n_mb`` of one input.  A DTensor sharded on
    dim 0 is cut on each rank's own rows (microbatch ``i`` takes the
    ``i``-th slice of every rank's rows: the same rows as one cut of the
    global batch, grouped otherwise, and no rows move)."""
    if isinstance(x, DTensor) and any(
            getattr(pl, "dim", None) == 0 for pl in x.placements):
        loc = x.to_local()
        k = loc.shape[0] // n_mb
        shape = (x.shape[0] // n_mb,) + tuple(x.shape[1:])
        return DTensor.from_local(loc[i * k:(i + 1) * k], x.device_mesh,
                                  x.placements, run_check=False, shape=shape,
                                  stride=contiguous_strides(shape))
    k = x.shape[0] // n_mb
    return x[i * k:(i + 1) * k]


def _split_microbatches(batch: dict, n_mb: int) -> list:
    """``n_mb`` batches cut from dim 0 of every input."""
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_mb:
            raise ValueError(f"{k}: batch {b} % microbatches {n_mb} != 0")
    return [{k: _rows(x, i, n_mb) for k, x in batch.items()}
            for i in range(n_mb)]


def _like(g, p):
    """Gradient ``g`` with the placements of its DTensor parameter ``p``
    (a partial sum is reduce-scattered); ``g`` itself otherwise."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value_and_grad(model: Model, params, batch):
    """(loss, grads in each parameter's dtype and, on a mesh, with its
    placements).  A parameter the loss does not reach gets a zero
    gradient, as under ``jax.grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = model.loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else _like(g, p)
               for p, g in zip(leaves, grads)])
    return loss.detach(), tree_map(lambda _: next(it), params)


def _full(x):
    """A metric as a plain tensor (a DTensor's full value)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
        g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
        for mb in _split_microbatches(batch, n_mb):
            loss, grads = _value_and_grad(model, params, mb)
            g_sum = tree_map(lambda a, g: a + g.to(acc_dt), g_sum, grads)
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / n_mb
        return loss_sum * inv, tree_map(lambda g: g.float() * inv, g_sum)

    @torch.no_grad()
    def train_step(state, batch):
        mesh = mesh_of(state)
        with on_mesh(mesh):
            new_state, metrics = _step(state, batch)
            if mesh is not None:
                new_state = tree_map(_like, new_state, state)
                metrics = tree_map(_full, metrics)
        return new_state, metrics

    def _step(state, batch):
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


def greedy(logits) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax.  A DTensor's vocab dim is
    gathered first (keeping its batch split): DTensor's argmax over a
    split dim reads each shard's offset from the data."""
    if isinstance(logits, DTensor):
        logits = logits.redistribute(logits.device_mesh, tuple(
            pl if getattr(pl, "dim", None) == 0 else Replicate()
            for pl in logits.placements))
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_serve_step(model: Model):
    """decode: (params, caches, tokens (B, 1)) -> (next_tokens (B, 1)
    int32, caches); the caches are written in place.  DTensor parameters
    run on their mesh, as in the train step."""

    def serve_step(params, caches, tokens):
        with on_mesh(mesh_of(params)):
            logits, caches = model.decode_step(params, caches, tokens)
            return greedy(logits), caches

    return serve_step


def make_prefill(model: Model):
    """prefill: (params, batch) -> (next_tokens (B, 1) int32, caches);
    with DTensor parameters the caches are DTensors on their mesh."""

    def prefill(params, batch):
        with on_mesh(mesh_of(params)):
            logits, caches = model.prefill(params, batch)
            return greedy(logits), caches

    return prefill
