"""Meta-tensor stand-ins for every model input, and abstract params,
caches and optimizer state (``repro.launch.specs``' counterpart): the
reference's shapes and dtypes, on the meta device, so nothing is
allocated."""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import lm
from ..optim import adamw_init


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for one step's data inputs (train or prefill)."""
    B = shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    d = {}
    if cfg.input_kind == "embeds":
        d["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
        d["positions"] = _sds((3, B, S), i32)
    elif cfg.input_kind == "codes":
        d["tokens"] = _sds((B, S, cfg.n_codebooks), i32)
    else:
        d["tokens"] = _sds((B, S), i32)
    if shape.kind == "train":
        if cfg.input_kind == "codes":
            d["labels"] = _sds((B, S, cfg.n_codebooks), i32)
        else:
            d["labels"] = _sds((B, S), i32)
    return d


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B = shape.global_batch
    i32 = torch.int32
    d = {}
    if cfg.input_kind == "embeds":
        d["embeds"] = _sds((B, 1, cfg.d_model), torch.bfloat16)
        d["positions"] = _sds((3, B, 1), i32)
    elif cfg.input_kind == "codes":
        d["tokens"] = _sds((B, 1, cfg.n_codebooks), i32)
    else:
        d["tokens"] = _sds((B, 1), i32)
    return d


def abstract_params(cfg: ArchConfig):
    """(params on the meta device, logical axes tree)."""
    return lm.init_params(cfg, device="meta")


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int):
    return lm.init_cache(cfg, batch, max_seq, device="meta")


def abstract_opt_state(param_shapes):
    return adamw_init(param_shapes)
