"""pixtral-12b [vlm]: Pixtral ViT frontend (stubbed) + Mistral-Nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072.  The vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (B, n_patches, d)
prepended to the token stream (early fusion).
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="transformer",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=131072,
        norm="rmsnorm",
        act="silu_glu",
        rope_theta=1_000_000.0,
        n_patches=1024,  # stub image: 1024 patch embeddings, early-fused
        tie_embeddings=False,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
