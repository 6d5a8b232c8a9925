"""Plain PyTorch version of the fmocc kernels: the vectorized occ of
``core.fmindex`` in the matching bucket layout."""

from __future__ import annotations

import torch

from ...core.fmindex import FMArrays, occ_base_v, occ_opt_v


def occ_ref(fm: FMArrays, c: torch.Tensor, i: torch.Tensor, *,
            layout: str = "eta32") -> torch.Tensor:
    """Occ(c, i) over the ``layout`` bucket rows; same shape as ``c``."""
    return (occ_opt_v if layout == "eta32" else occ_base_v)(fm, c, i)
