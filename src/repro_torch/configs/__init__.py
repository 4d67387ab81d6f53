"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The port's own copy of the JAX package's registry, number for number:
one module per assigned architecture (exact public-literature configs),
plus ``reduced(cfg)`` which shrinks any config to a CPU-test size of the
same family (fewer/narrower layers, few experts, tiny vocab).  The full
configs are served on the card (``chip_smoke.py`` phase 16).
"""
from __future__ import annotations

import dataclasses

from ..config import ArchConfig, SHAPES, ShapeConfig

from . import (
    granite_8b,
    h2o_danube_1_8b,
    llama4_maverick_400b_a17b,
    mamba2_1_3b,
    olmo_1b,
    pixtral_12b,
    qwen3_moe_235b_a22b,
    recurrentgemma_9b,
    stablelm_3b,
    whisper_medium,
)

__all__ = [
    "ARCHS",
    "get_arch",
    "reduced",
    "SHAPES",
    "cell_skip_reason",
    "runnable_cells",
]

ARCHS = {
    m.config().name: m.config()
    for m in (
        pixtral_12b,
        olmo_1b,
        granite_8b,
        stablelm_3b,
        h2o_danube_1_8b,
        recurrentgemma_9b,
        qwen3_moe_235b_a22b,
        llama4_maverick_400b_a17b,
        mamba2_1_3b,
        whisper_medium,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    """Why a (arch x shape) dry-run cell is skipped (None = runnable).

    Per the assignment: ``long_500k`` needs sub-quadratic attention and is
    skipped for pure full-attention archs.
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full attention: 500k KV cache is not sub-quadratic"
    return None


def runnable_cells():
    """All (arch, shape, skip_reason) cells; skip_reason None = runnable."""
    out = []
    for a, cfg in ARCHS.items():
        for s, shp in SHAPES.items():
            out.append((a, s, cell_skip_reason(cfg, shp)))
    return out


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.hybrid_period else min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(min(cfg.n_kv_heads, 4) or 0) if cfg.n_heads else 0,
        d_head=16 if cfg.n_heads else cfg.d_head,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        attn_q_chunk=16,
        ce_chunk=64,
        remat=False,
        n_microbatches=1,
        dtype="float32",  # XLA:CPU lacks some bf16 dot thunks
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=32,
                  moe_group=64)
    if cfg.family == "mamba2":
        kw.update(d_inner=128, ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.family == "rglru_hybrid":
        kw.update(hybrid_period=3, lru_width=64, window=16)
    if cfg.window:
        kw.update(window=16)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_frames=12)
    if cfg.n_patches:
        kw.update(n_patches=8)
    return dataclasses.replace(cfg, **kw)
