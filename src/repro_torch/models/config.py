"""Architecture configuration schema for all assigned model families.

A copy of the reference's schema; ``pdtype``/``cdtype`` are torch dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0  # per-expert FFN hidden
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # DeepSeek: first layer(s) dense
    d_ff_dense: int = 0  # hidden of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style block pattern."""

    pattern: tuple[str, ...] = ("recurrent", "recurrent", "attention")
    window: int = 2048
    conv_width: int = 4
    lru_dim: int = 0  # defaults to d_model


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None
    rope_theta: float = 10_000.0
    attn_bias: bool = False
    mlp_bias: bool = False
    activation: str = "silu"
    norm: str = "rmsnorm"  # or "layernorm"
    use_rope: bool = True
    tie_embeddings: bool = True

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    hybrid: HybridConfig | None = None

    # audio/vlm stub frontends
    encoder_layers: int = 0  # whisper: separate encoder stack
    num_patch_tokens: int = 0  # internvl: prepended image-patch embeddings

    # attention implementation: "naive" materializes (Sq,Skv) scores (the
    # recorded baseline); "blockwise" = online-softmax over KV blocks (§Perf
    # optimization); "auto" picks blockwise for kv_len >= 4096.
    attention_impl: str = "naive"

    # MoE dispatch: "scatter" = f32 scatter-add into the (B,E,C,d) buffer
    # (baseline; GSPMD all-reduces the full buffer across the EP axis);
    # "gather" = int32 slot-index scatter + local token gather (§Perf fix).
    moe_dispatch: str = "scatter"

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # adam moments (+master when f32)
    remat: bool = True
    scan_layers: bool = True

    # serving
    supports_decode: bool = True
    subquadratic: bool = False  # may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid else 3),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.head_dim else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            scan_layers=self.scan_layers,
            encoder_layers=2 if self.encoder_layers else 0,
            num_patch_tokens=4 if self.num_patch_tokens else 0,
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                num_experts=4,
                top_k=2,
                num_shared=min(self.moe.num_shared, 1),
                d_ff_expert=32,
                capacity_factor=2.0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=64,
            )
        if self.mla:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16
            )
        if self.hybrid:
            kw["hybrid"] = HybridConfig(
                pattern=self.hybrid.pattern, window=16, conv_width=4
            )
        return self.with_(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
