"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
— arXiv:2401.16818.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
The bounded window makes this arch runnable on the long_500k cell.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="transformer",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_head=80,
        d_ff=6912,
        vocab=32000,
        norm="rmsnorm",
        act="silu_glu",
        window=4096,  # mistral-style SWA
        tie_embeddings=True,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
