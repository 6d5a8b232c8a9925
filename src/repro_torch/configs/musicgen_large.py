"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec RVQ
tokens: 4 codebooks x vocab 2048, summed input embeddings, 4 output heads.
The EnCodec frontend is a STUB (tokens arrive precomputed, delay pattern
applied by the data pipeline)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    act="swiglu", n_codebooks=4, input_kind="codes",
)
