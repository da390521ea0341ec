"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m lineage; spec'd as 40e top-8].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    mlp_act="silu_glu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    fsdp=True,
    seq_shard=True,
)
