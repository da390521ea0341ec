"""granite-20b [dense] — llama-arch, code [arXiv:2405.04324; hf].

52L d_model=6144 48H (GQA kv=1 => MQA) d_ff=24576 vocab=49152.
gpt-bigcode lineage: plain GELU MLP rather than SwiGLU.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    mlp_act="gelu",
    fsdp=True,
    seq_shard=True,
)
