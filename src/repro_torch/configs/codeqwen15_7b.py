"""codeqwen1.5-7b [dense] — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    mlp_act="silu_glu",
    rope_theta=1_000_000.0,
    fsdp=True,
    seq_shard=True,
)
