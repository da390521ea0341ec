"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    mlp_act="silu_glu",
    tie_embeddings=True,
    fsdp=False,  # 135M: pure DP replication is optimal
)
