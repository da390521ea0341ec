"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H (MLA) d_ff_expert=2048 vocab=129280, MoE 256e top-8,
first 3 layers dense (d_ff=18432), MLA q_lora=1536 kv_lora=512.
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense layers (first_dense) use this
    vocab=129280,
    head_dim=128,
    mlp_act="silu_glu",
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  first_dense=3),
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    mtp=True,
    fsdp=True,
    seq_shard=True,
    bf16_params=True,
)
