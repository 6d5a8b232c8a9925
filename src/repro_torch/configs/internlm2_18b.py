"""InternLM2-1.8B [arXiv:2403.17297; hf] — dense, GQA kv=8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128,
    act="swiglu", rope_theta=1000000.0,
)
