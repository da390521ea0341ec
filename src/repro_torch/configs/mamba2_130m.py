"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attn-free (d_ff=0), vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 => 24 SSD heads, chunk 256.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,          # d_inner / head_dim
    n_kv_heads=24,
    d_ff=0,              # attn-free, no MLP block (Mamba-2 block only)
    vocab=50280,
    pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    fsdp=False,
    sub_quadratic=True,
)
