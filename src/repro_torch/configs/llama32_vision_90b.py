"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision lineage, scaled per assignment].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
is gated cross-attention to precomputed patch embeddings (frontend STUB:
``input_specs`` supplies (batch, 1600, d_model) image features).
"""

from .base import ArchConfig, VisionConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    mlp_act="silu_glu",
    rope_theta=500_000.0,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    vision=VisionConfig(n_image_tokens=1600, cross_every=5),
    fsdp=True,
    seq_shard=True,
    bf16_params=True,
)
