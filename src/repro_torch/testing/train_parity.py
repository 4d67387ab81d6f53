"""Compare two train states of the port (the card's against the CPU's,
two precisions, or the port's against the JAX package's carried across)
entry by entry, with the rounding-sensitive update entries held apart.

An update divides by the gradient's own scale ``sqrt(v_hat)``: where that
scale is below SMALL_G a rounding difference of the gradient moves the
update by up to ``2 * lr`` (AdamW; Adafactor's RMS clip bounds one entry
of an n-entry leaf by ``sqrt(n) * lr``).  Such entries are held at that
bound instead of the tolerance, and counted; a leaf in which every entry
is sensitive carries a gradient of pure rounding noise (the router of a
top-1 MoE, whose renormalized gate is exactly 1) and is listed.  Imports
neither jax nor the JAX package.
"""
from __future__ import annotations

import math

import torch

__all__ = ["SMALL_G", "compare_states"]

SMALL_G = 1e-6  # sqrt(v_hat) below this: the update is rounding-sensitive


def _v_hat(opt: dict, v) -> torch.Tensor:
    """The optimizer's estimate of g**2 for one parameter (``v``: its
    second-moment state)."""
    if "m" in opt:  # AdamW, b2 = 0.95
        return v / (1.0 - 0.95 ** int(opt["step"]))
    if "v_row" in v:  # Adafactor, factored: the rank-1 product
        r = v["v_row"] / torch.clamp(v["v_row"].mean(dim=-1, keepdim=True),
                                     min=1e-30)
        return r[..., None] * v["v_col"][..., None, :]
    return v["v"]


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _v_leaf(v_tree: dict, path: str):
    """The second-moment state of the parameter at ``path`` (a tensor, or
    Adafactor's {"v_row", "v_col"} / {"v"} dict)."""
    if path in v_tree:
        return v_tree[path]
    return {k.rsplit("/", 1)[1]: t for k, t in v_tree.items()
            if k.rsplit("/", 1)[0] == path}


def compare_states(got: dict, want: dict, lr: float, rtol: float,
                   atol: float, skip: dict | None = None) -> dict:
    """``got`` against ``want`` (train states: params, opt[, resid]; same
    keys, shapes and dtypes, or ValueError), computed on ``want``'s
    device.

    ``skip`` ({parameter path: bool mask}) leaves entries out of that
    parameter's leaves in every section.  Returns ``worst`` (the largest
    |got - want| / (atol + rtol |want|) over the entries held at the
    tolerance) and ``worst_at`` (its leaf), ``sensitive_worst`` (the
    largest |got - want| / bound over the sensitive entries),
    ``n_sensitive_out`` (sensitive entries outside the tolerance, noise
    leaves left out) and ``noise_leaves`` (their paths)."""
    opt = want["opt"]
    v_tree = dict(_walk(opt["v"]))
    out = {"worst": 0.0, "worst_at": None, "sensitive_worst": 0.0,
           "n_sensitive_out": 0, "noise_leaves": []}
    if sorted(got) != sorted(want):
        raise ValueError(f"state keys {sorted(got)} vs {sorted(want)}")
    for section in sorted(want):
        gl, wl = dict(_walk(got[section])), dict(_walk(want[section]))
        if sorted(gl) != sorted(wl):
            raise ValueError(f"{section}: the trees differ")
        for path, w in wl.items():
            g = gl[path]
            where = f"{section}/{path}"
            if g.shape != w.shape or g.dtype != w.dtype:
                raise ValueError(f"{where}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
            w = w.detach().float()
            g = g.detach().float().to(w.device)
            keep = torch.ones(w.shape, dtype=torch.bool, device=w.device)
            for key, mask in (skip or {}).items():
                if (path == key or path.endswith("/" + key)) \
                        and mask.shape == w.shape:
                    keep &= ~mask.to(w.device)
            small = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
            if section == "params":
                small = torch.sqrt(_v_hat(opt, _v_leaf(v_tree, path))
                                   .float().to(w.device)) < SMALL_G
            ratio = (g - w).abs() / (atol + rtol * w.abs())
            held = ratio[keep & ~small]
            if held.numel() and float(held.max()) > out["worst"]:
                out["worst"], out["worst_at"] = float(held.max()), where
            sens = keep & small
            if not sens.any():
                continue
            bound = 2 * lr * (1.0 if "m" in opt else math.sqrt(w.numel()))
            out["sensitive_worst"] = max(out["sensitive_worst"], float(
                ((g - w).abs()[sens] / bound).max()))
            if bool(small.all()):
                out["noise_leaves"].append(path)
            else:
                out["n_sensitive_out"] += int((ratio[sens] > 1).sum())
    return out
