"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf] — dense, QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, head_dim=64,
    qkv_bias=True, act="swiglu", rope_theta=1000000.0,
)
