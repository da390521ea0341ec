"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1 => MQA local attention, window 2048)
d_ff=12288 vocab=256000; block pattern (rec, rec, attn).
"""

from .base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    mlp_act="gelu_glu",
    window=2048,
    pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=None, d_conv=4, c=8.0),
    fsdp=True,
    seq_shard=True,
    sub_quadratic=True,
)
