"""The 10 assigned architectures (exact public configs) + reduced smoke
variants + the paper's own pipeline config handle.

Sources are cited per entry ([hf]/[arXiv]); numbers are verbatim from the
assignment table.
"""

from __future__ import annotations

import dataclasses

from .base import ArchConfig
from .qwen15_05b import CONFIG as qwen15_05b
from .internlm2_18b import CONFIG as internlm2_18b
from .nemotron4_340b import CONFIG as nemotron4_340b
from .qwen15_110b import CONFIG as qwen15_110b
from .llama4_scout import CONFIG as llama4_scout
from .dbrx_132b import CONFIG as dbrx_132b
from .mamba2_130m import CONFIG as mamba2_130m
from .qwen2_vl_72b import CONFIG as qwen2_vl_72b
from .musicgen_large import CONFIG as musicgen_large
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        qwen15_05b, internlm2_18b, nemotron4_340b, qwen15_110b,
        llama4_scout, dbrx_132b, mamba2_130m, qwen2_vl_72b,
        musicgen_large, zamba2_7b,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — structure preserved."""
    c = get_arch(name)
    small = dict(
        n_layers=2 if not c.shared_attn_every else 8,
        d_model=64,
        d_ff=128,
        vocab=256,
        head_dim=16,
        n_heads=0 if c.is_attention_free else 4,
        n_kv_heads=0 if c.is_attention_free else max(1, min(c.n_kv_heads, 2)),
        remat=False,
    )
    if c.moe_experts:
        small.update(moe_experts=4, moe_top_k=min(c.moe_top_k, 2))
    if c.ssm_state:
        small.update(ssm_state=16, ssm_headdim=16, ssm_expand=2)
    if c.shared_attn_every:
        small.update(shared_attn_every=3)
    if c.n_codebooks:
        small.update(n_codebooks=c.n_codebooks, vocab=64)
    return dataclasses.replace(c, **small)
