"""llama4-maverick-400b-a17b [moe]: alternating dense/MoE, top-1 routing
— [hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 on
every other layer (moe_every=2).  Early-fusion multimodality is out of the
assigned backbone scope (text backbone only).
"""
from ..config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="transformer",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202048,
        norm="rmsnorm",
        act="silu_glu",
        rope_theta=500_000.0,
        n_experts=128,
        top_k=1,
        d_ff_expert=8192,
        moe_every=2,  # alternate dense / MoE
        moe_impl="grouped",
        moe_group=512,
        tie_embeddings=False,
        optimizer="adafactor",
        n_microbatches=8,
        grad_accum_dtype="bfloat16",
        remat_block=6,
        attn_q_chunk=256,  # 40 heads don't shard on 16: bound replicated scores
    )
