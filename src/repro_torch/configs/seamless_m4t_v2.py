"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  Transformer backbone
only: 24L speech encoder over STUB frame embeddings (precomputed
(batch, seq/4, d_model) features) + 24L text decoder with cross-attention.
"""

from .base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers; encoder has its own 24 (EncoderConfig)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    mlp_act="gelu",
    encoder=EncoderConfig(n_layers=24, frontend="stub", frame_ratio=4),
    fsdp=False,  # 2.3B total: DP+TP suffices
    # unrolled layers: exact AOT cost accounting for the enc+dec stacks
    # (cheap at d_model=1024; scanned archs use the probe correction instead)
    scan_layers=False,
)
