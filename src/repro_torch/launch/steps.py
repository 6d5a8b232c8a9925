"""Step factories: prefill_step / decode_step closures over an
ArchConfig (``repro.launch.steps``' counterpart; the train step is not
ported yet)."""

from __future__ import annotations

from ..configs.base import ArchConfig
from ..models import lm


def make_prefill_step(cfg: ArchConfig, *, q_block=512, kv_block=512):
    def prefill_step(params, batch):
        hidden = lm.forward(params, cfg, batch, q_block=q_block,
                            kv_block=kv_block, return_hidden=True)
        # head applied to the last position only (next-token logits)
        return lm.apply_head(params, cfg, hidden[:, -1])
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, cache, batch, pos):
        logits, cache = lm.decode_step(params, cfg, cache, batch, pos)
        return logits[:, -1], cache
    return decode_step
