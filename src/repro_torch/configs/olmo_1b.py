"""olmo-1b [dense]: OLMo with non-parametric LayerNorm — arXiv:2402.00838.

16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=8192 vocab=50304.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b",
        family="transformer",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=8192,
        vocab=50304,
        norm="nonparametric",  # OLMo: LN without trainable params
        act="silu_glu",
        tie_embeddings=True,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
