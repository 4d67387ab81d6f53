"""Optimizers: AdamW and Adafactor (for the 235B/400B MoE configs).

Functional and optax-shaped, as the JAX package's:

    opt = make_optimizer(cfg.optimizer, lr=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and state are nested dicts of tensors; the state is
``{"step": 0-d int32, ...}`` with f32 moments on the parameters' device.

  * adamw: ``m`` and ``v`` shaped like each parameter (f32).
  * adafactor: factored second moment (no momentum): ``v_row`` drops the
    last dim, ``v_col`` the second-to-last; a parameter with fewer than
    two dims of size > 1 keeps a full ``v``.

:func:`opt_state_specs` gives the state as a ParamSpec tree (the logical
axes carried over for the mesh rules).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..models.params import ParamSpec, tree_leaves, tree_map

__all__ = [
    "Optimizer",
    "adafactor",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "make_optimizer",
    "opt_state_specs",
]


class Optimizer(NamedTuple):
    name: str
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm); each leaf keeps
    its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply_updates(params, updates):
    """``p + u`` in f32, cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "m": tree_map(lambda p: _zeros(p.shape, p), params),
                "v": tree_map(lambda p: _zeros(p.shape, p), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.float()
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mh = m2 / bc1
            vh = v2 / bc2
            u = -lr * (mh / (torch.sqrt(vh) + eps)
                       + weight_decay * p.float())
            return u, m2, v2

        out = tree_map(upd, grads, state["m"], state["v"], params)
        updates, m, v = (tree_map(lambda o: o[i], out) for i in range(3))
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def init(params):
        def leaf(p):
            if _factored(p.shape):
                return {"v_row": _zeros(p.shape[:-1], p),
                        "v_col": _zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _zeros(p.shape, p)}

        return {"step": _step0(params), "v": tree_map(leaf, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay)  # increasing decay schedule

        def upd(g, s):
            g = g.float()
            g2 = g * g + eps
            if "v_row" in s:
                v_row = beta * s["v_row"] + (1 - beta) * g2.mean(dim=-1)
                v_col = beta * s["v_col"] + (1 - beta) * g2.mean(dim=-2)
                row_mean = v_row.mean(dim=-1, keepdim=True)
                r = (v_row / torch.clamp(row_mean, min=eps))[..., None]
                c = v_col[..., None, :]
                u = g * torch.rsqrt(torch.clamp(r * c, min=eps))
                ns = {"v_row": v_row, "v_col": v_col}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                ns = {"v": v}
            # update clipping (RMS <= clip_threshold); the mean as a sum
            # over the count (the same arithmetic): DTensor's mean over a
            # dim split unevenly (94 stacked layers on 16 ranks) gathers
            # the whole tensor first, its sum stays a partial sum
            rms = torch.sqrt(torch.sum(u * u) / u.numel() + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u, ns

        out = tree_map(upd, grads, state["v"])
        updates, new_v = (tree_map(lambda o: o[i], out) for i in range(2))
        return updates, {"step": step, "v": new_v}

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, lr: float = 3e-4, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr, **kw)
    if name == "adafactor":
        return adafactor(lr=lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# Abstract state
# ---------------------------------------------------------------------------


def opt_state_specs(name: str, param_specs_tree):
    """ParamSpec tree of the optimizer state of ``name`` for a ParamSpec
    tree of parameters."""
    def like(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, dtype=torch.float32, init="zeros")

    step = ParamSpec((), (), dtype=torch.int32, init="zeros")
    if name == "adamw":
        return {"step": step, "m": tree_map(like, param_specs_tree),
                "v": tree_map(like, param_specs_tree)}
    if name == "adafactor":
        def leaf(s: ParamSpec):
            if _factored(s.shape):
                return {
                    "v_row": ParamSpec(s.shape[:-1], s.axes[:-1],
                                       dtype=torch.float32, init="zeros"),
                    "v_col": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                       s.axes[:-2] + s.axes[-1:],
                                       dtype=torch.float32, init="zeros"),
                }
            return {"v": like(s)}

        return {"step": step, "v": tree_map(leaf, param_specs_tree)}
    raise ValueError(name)
