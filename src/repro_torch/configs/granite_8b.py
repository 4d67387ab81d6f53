"""granite-8b [dense]: IBM Granite code model, llama arch — arXiv:2405.04324.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-8b",
        family="transformer",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=49152,
        norm="rmsnorm",
        act="silu_glu",
        rope_theta=10_000_000.0,
        tie_embeddings=False,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
