"""Mamba2-130M [arXiv:2405.21060; unverified] — attention-free SSD."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, rope="none",
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    subquadratic=True,
)
