"""Config system: architectures (--arch <id>) and input-shape cells.

The port's own copy of the JAX package's ``config`` module (it imports
nothing of that package).  One :class:`ArchConfig` per assigned
architecture (``repro_torch/configs/<id>.py``).  Shape cells follow the
assignment: train_4k / prefill_32k / decode_32k / long_500k.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "pad_vocab"]


def pad_vocab(vocab: int, multiple: int = 16) -> int:
    """Pad vocab so the 16-way model axis divides it (MaxText practice)."""
    return ((vocab + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # transformer | mamba2 | rglru_hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric
    act: str = "silu_glu"  # silu_glu | gelu
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention width
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1  # 1: every layer MoE; 2: alternate dense/MoE
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"  # scatter (small/CPU) | grouped (pod meshes)
    moe_group: int = 512  # token-group size for the grouped dispatch
    moe_group_chunk: int = 1  # >1: scan group chunks (refuted: re-gathers weights)
    # SSM (mamba2)
    ssm_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (recurrentgemma): layer pattern (rec, rec, local-attn) repeating
    hybrid_period: int = 0  # 3 for recurrentgemma; 0 = not hybrid
    lru_width: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500
    # vlm (pixtral): stub patch embeddings prepended to the token stream
    n_patches: int = 0
    # numerics / compile strategy
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    remat: bool = True
    scan_layers: bool = True
    ce_chunk: int = 2048
    attn_q_chunk: int = 1024  # query-chunked attention (memory-bounded)
    n_microbatches: int = 1  # grad-accumulation microbatches per step
    optimizer: str = "adamw"  # adamw | adafactor (MoE giants)
    remat_block: int = 0  # >0: two-level remat, outer scan over blocks of k
    grad_accum_dtype: str = "float32"  # float32 | bfloat16 (giants)
    sharding_profile: str = "tp_fsdp"  # tp_fsdp | zero3 (small dense, train)

    @property
    def vocab_pad(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode (bounded state)?"""
        if self.family in ("mamba2", "rglru_hybrid"):
            return True
        return self.window is not None

    @property
    def qkv_dims(self) -> tuple:
        return self.n_heads * self.d_head, self.n_kv_heads * self.d_head

    def n_params(self) -> float:
        """Approximate parameter count (for 6ND model-FLOP accounting)."""
        d, l, v = self.d_model, self.n_layers, self.vocab_pad
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "mamba2":
            din, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.n_ssm_heads
            per = d * (2 * din + 2 * g * n + h) + din * d + (din + 2 * g * n) * self.d_conv
            return emb + l * (per + d) + d
        qd, kvd = self.qkv_dims
        attn = d * qd + 2 * d * kvd + qd * d
        dense_mlp = 3 * d * self.d_ff if self.act == "silu_glu" else 2 * d * self.d_ff
        if self.n_experts:
            moe_mlp = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            n_moe = l // self.moe_every
            n_dense = l - n_moe
            mlp_total = n_moe * moe_mlp + n_dense * dense_mlp
        else:
            mlp_total = l * dense_mlp
        if self.family == "rglru_hybrid":
            # 2/3 of layers replace attention with the RG-LRU block
            w = self.lru_width or d
            rec = d * w * 2 + w * d + 2 * w * 4 + 2 * w  # gates+convs approx
            n_rec = (l * 2) // 3
            attn_total = (l - n_rec) * attn + n_rec * rec
        else:
            attn_total = l * attn
        total = emb + attn_total + mlp_total + 2 * l * d + d
        if self.family == "encdec":
            qd, kvd = self.qkv_dims
            enc = self.n_enc_layers * (attn + dense_mlp + 2 * d)
            cross = l * (d * qd + 2 * d * kvd + qd * d + d)
            total += enc + cross
        return float(total)

    def n_active_params(self) -> float:
        """Active params per token (= n_params for dense; top-k slice for MoE)."""
        if not self.n_experts:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        moe_mlp_all = self.n_experts * 3 * d * self.d_ff_expert
        moe_mlp_act = self.top_k * 3 * d * self.d_ff_expert
        n_moe = l // self.moe_every
        return self.n_params() - n_moe * (moe_mlp_all - moe_mlp_act)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.d_inner else 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
