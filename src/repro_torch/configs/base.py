"""Architecture configuration schema shared by all 10 assigned archs.

The port's own copy of the reference's plain-data configs: every field is
plain data so configs hash and compare cleanly.  ``reduced()`` produces
the CPU-smoke variant of the same family (small widths, few
layers/experts, tiny vocab); ``param_dtype`` is a torch dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts
    first_dense: int = 0       # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int | None = None   # default d_model
    d_conv: int = 4
    c: float = 8.0                 # the RG-LRU gate constant


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 24
    frontend: str = "stub"         # precomputed frame/patch embeddings
    frame_ratio: int = 4           # encoder frames = seq_len // frame_ratio


@dataclass(frozen=True)
class VisionConfig:
    n_image_tokens: int = 1600     # stub: precomputed patch embeddings
    cross_every: int = 5           # every 5th layer is cross-attention


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads
    mlp_act: str = "silu_glu"      # silu_glu | gelu
    window: int | None = None      # sliding-window attention size
    pattern: tuple[str, ...] = ("attn",)  # per-layer mixer kinds, cycled
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder: EncoderConfig | None = None
    vision: VisionConfig | None = None
    mtp: bool = False              # multi-token-prediction extra head
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # distribution knobs
    fsdp: bool = False             # ZeRO-3 weight sharding over the data axis
    seq_shard: bool = False        # Megatron-SP: inter-block h sharded over model
    bf16_params: bool = False      # bf16 weights + bf16 AdamW moments (671B-scale)
    remat: bool = True
    scan_layers: bool = True
    sub_quadratic: bool = False    # eligible for long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def param_dtype(self):
        import torch
        return torch.bfloat16 if self.bf16_params else torch.float32

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant of the same family."""
        kw: dict = dict(
            n_layers=min(self.n_layers, len(self.pattern) * 2),
            d_model=128, n_heads=4, d_ff=256, vocab=512,
            n_kv_heads=min(self.n_kv_heads, 2), head_dim=32,
            fsdp=False, window=min(self.window, 64) if self.window else None,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, d_ff_expert=64,
                first_dense=min(self.moe.first_dense, 1))
            kw["n_layers"] = 2 + kw["moe"].first_dense
        if self.mla:
            kw["mla"] = MLAConfig(q_lora=64, kv_lora=32, qk_nope=16, qk_rope=16, v_head=16)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.rglru:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=None)
            kw["n_layers"] = 3
        if self.encoder:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=2)
        if self.vision:
            kw["vision"] = dataclasses.replace(self.vision, n_image_tokens=16, cross_every=2)
            kw["n_layers"] = 4
        return self.replace(**kw)


# Shape grid shared by all LM archs (the assignment's 4 shapes).
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
