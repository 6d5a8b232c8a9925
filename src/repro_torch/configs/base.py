"""Architecture configuration schema + the four assigned input shapes."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    act: str = "swiglu"          # swiglu | sq_relu
    rope: str = "rope"           # rope | mrope | none
    rope_theta: float = 10000.0
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0
    # audio (musicgen): number of EnCodec codebooks
    n_codebooks: int = 0
    # frontend stub: "tokens" | "embeds" (vlm patch embeds) | "codes"
    input_kind: str = "tokens"
    dtype: str = "bfloat16"
    remat: bool = True
    # "full": recompute everything (min memory, re-pays TP all-reduces in
    # the backward); "dots": save matmul/AR outputs (hillclimb lever)
    remat_policy: str = "full"
    # scan-over-layers (True) vs python-unrolled layers (False — used by
    # the dry-run cost probes, where while-loop bodies are undercounted)
    scan_layers: bool = True
    # long-context capability (sub-quadratic path exists)
    subquadratic: bool = False
    # set when vocab was padded for sharding divisibility (loss masks pads)
    vocab_real: int = 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        n = 0
        vocab_in = self.vocab * (self.n_codebooks or 1)
        n += vocab_in * d                       # embed
        n += self.vocab * d * (self.n_codebooks or 1)   # lm head(s)
        if self.family == "ssm" or self.family == "hybrid":
            d_in = self.ssm_expand * d
            H = d_in // self.ssm_headdim
            per = d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + H) \
                + d_in * d + 2 * d
            n += per * L
            if self.family == "hybrid" and self.shared_attn_every:
                hd = self.head_dim
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d + 3 * d * self.d_ff
        else:
            hd = self.head_dim
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.moe_experts:
                ffn = self.moe_experts * 3 * d * self.d_ff + d * self.moe_experts
            else:
                nmat = 2 if self.act == "sq_relu" else 3
                ffn = nmat * d * self.d_ff
            n += (attn + ffn + 2 * d) * L
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.moe_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        ffn_active = self.moe_top_k * 3 * d * self.d_ff
        vocab_side = 2 * self.vocab * d
        return vocab_side + (attn + ffn_active + 2 * d) * L


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs a sub-quadratic path (SSM/hybrid only) — DESIGN.md §5."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
