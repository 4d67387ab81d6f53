"""Error-feedback gradient compression (bf16 / int8), value-faithful.

Compressing the data-parallel gradient reduction with *error feedback*
(Seide et al. 2014; Karimireddy et al. 2019):

    e      <- residual + g          # fold in the carried error
    q      <- Q(e)                  # bf16 round or int8 per-tensor scale
    resid' <- e - DQ(q)             # carry the quantization error
    update uses DQ(q)

As in the JAX package the transform is value-faithful: the optimizer
consumes exactly what a compressed wire would deliver, error feedback
included; on one device there is no wire, and ``wire_fraction`` gives
the bytes a compressed reduction would move.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.params import tree_map

__all__ = ["CompressionConfig", "init_residual", "compress_grads",
           "wire_fraction"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | bf16 | int8


def init_residual(params, cfg: CompressionConfig):
    """f32 zeros shaped like ``params`` (None without compression)."""
    if cfg.kind == "none":
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q_bf16(x):
    return x.to(torch.bfloat16).float()


def _q_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_grads(grads, residual, cfg: CompressionConfig):
    """Returns (decompressed_grads, new_residual)."""
    if cfg.kind == "none":
        return grads, residual
    quant = {"bf16": _q_bf16, "int8": _q_int8}[cfg.kind]

    def leaf(g, r):
        e = g.float() + r
        dq = quant(e)
        return dq, e - dq

    out = tree_map(leaf, grads, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def wire_fraction(cfg: CompressionConfig) -> float:
    """Wire-byte fraction against f32 gradients."""
    return {"none": 1.0, "bf16": 0.5, "int8": 0.25}[cfg.kind]
