"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 ratio
— arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern: (recurrent, recurrent, local-attn) repeating; 38 = 12 periods + 2
trailing recurrent layers.  Bounded state => runs long_500k.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="rglru_hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_head=256,
        d_ff=12288,
        vocab=256_000,
        norm="rmsnorm",
        act="silu_glu",
        window=2048,  # local attention width
        hybrid_period=3,
        lru_width=4096,
        tie_embeddings=True,
        n_microbatches=4,
    )
