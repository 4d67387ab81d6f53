"""mamba2-1.3b [ssm]: SSD (state-space duality) — arXiv:2405.21060.

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128, d_inner=4096,
head_dim=64 (64 SSD heads), 1 B/C group.  O(1) decode state => long_500k.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b",
        family="mamba2",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        norm="rmsnorm",
        d_inner=4096,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_groups=1,
        d_conv=4,
        ssm_chunk=128,
        tie_embeddings=True,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
