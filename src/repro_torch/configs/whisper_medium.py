"""whisper-medium [audio]: enc-dec backbone; conv/log-mel frontend STUBBED
— arXiv:2212.04356.

24 enc + 24 dec layers, d_model=1024 16H (MHA) d_ff=4096 vocab=51865,
n_frames=1500.  ``input_specs()`` provides precomputed frame embeddings.
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab=51865,
        norm="layernorm",
        act="gelu",
        n_enc_layers=24,
        n_frames=1500,
        tie_embeddings=True,
        n_microbatches=1,
        sharding_profile="zero3",  # §Perf Cell D: 1.8-4.9x over tp_fsdp
    )
