"""Zamba2-7B [arXiv:2411.15242; unverified] — hybrid: Mamba2 backbone with
a SHARED attention block applied every 6 SSM layers (81 = 13x6 + 3)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    act="swiglu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    shared_attn_every=6,
    subquadratic=True,
)
