"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B; hf] — dense, GQA kv=8, QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, head_dim=128,
    qkv_bias=True, act="swiglu", rope_theta=1000000.0,
)
