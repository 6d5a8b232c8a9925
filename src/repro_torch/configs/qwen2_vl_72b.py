"""Qwen2-VL-72B [arXiv:2409.12191; hf] — VLM backbone; M-RoPE; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings +
(3, B, S) M-RoPE position ids)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    qkv_bias=True, act="swiglu", rope="mrope", rope_theta=1000000.0,
    input_kind="embeds",
)
