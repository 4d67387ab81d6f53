"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32, i.e. MHA) d_ff=6912 vocab=50304.
LayerNorm + SwiGLU per the StableLM family.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="transformer",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=6912,
        vocab=50304,
        norm="layernorm",
        act="silu_glu",
        tie_embeddings=True,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
