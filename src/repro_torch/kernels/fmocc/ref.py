"""Plain PyTorch version of the fmocc round kernel: the vectorized occ and
extension of ``core.fmindex`` in the matching bucket layout."""

from __future__ import annotations

import torch

from ...core.fmindex import (FMArrays, backward_ext_v, forward_ext_v,
                             occ_base_v, occ_opt_v)


def occ_ref(fm: FMArrays, c: torch.Tensor, i: torch.Tensor, *,
            layout: str = "eta32") -> torch.Tensor:
    """Occ(c, i) over the ``layout`` bucket rows; same shape as ``c``."""
    return (occ_opt_v if layout == "eta32" else occ_base_v)(fm, c, i)


def ext_round_ref(fm: FMArrays, which: str, k, l, s, c, *,
                  layout: str = "eta32") -> torch.Tensor:
    """(k', l', s') of the ``which`` ("bwd"/"fwd") extension as one int32
    (3, ...) tensor, every occ lookup through ``occ_ref`` of ``layout``."""
    fn = forward_ext_v if which == "fwd" else backward_ext_v
    return torch.stack(fn(fm, k, l, s, c, occ_fn=(
        occ_opt_v if layout == "eta32" else occ_base_v)))
