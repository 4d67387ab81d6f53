"""qwen3-moe-235b-a22b [moe] — [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) vocab=151936, MoE 128 experts top-8 with
d_ff_expert=1536 (every layer MoE; no dense FFN).  Note q-dim 8192 > d_model.
Uses the grouped (GShard-style) one-hot dispatch — the paper's Phi-kernel
pattern — and adafactor (235B params).
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="transformer",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_head=128,
        d_ff=1536,
        vocab=151936,
        norm="rmsnorm",
        act="silu_glu",
        rope_theta=1_000_000.0,
        n_experts=128,
        top_k=8,
        d_ff_expert=1536,
        moe_every=1,
        moe_impl="grouped",
        moe_group=512,
        tie_embeddings=False,
        optimizer="adafactor",
        n_microbatches=8,
        grad_accum_dtype="bfloat16",
        remat_block=2,
    )
