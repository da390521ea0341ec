"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding window 4096.
SWA makes decode memory O(window), so long_500k is runnable.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    mlp_act="silu_glu",
    window=4096,
    fsdp=True,
    seq_shard=True,
    sub_quadratic=True,
)
