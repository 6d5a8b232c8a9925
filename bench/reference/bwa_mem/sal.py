"""Suffix-array lookup (SAL) — paper §4.5.

The PyTorch counterpart of ``repro.core.sal``:

* ``sal_direct``    — optimized: one gather from the UNCOMPRESSED suffix
                      array (Equation 1, ``j = S[i]``); the paper's 183x fix.

Batched over all lookups of a read batch (Fig-2 stage-major workflow).
"""

from __future__ import annotations

import numpy as np
import torch

from . import obs
from .contig import contig_edges
from .fmindex import FMArrays


def sal_direct(fm: FMArrays, rows: torch.Tensor) -> torch.Tensor:
    """rows (T,) int64 on fm's device -> SA values (T,) int32. One gather."""
    return fm.sa[rows]


def seeds_from_intervals(idx, mems_per_read, max_occ: int, *, device,
                         compressed: bool = False, occ_eta32: bool = True):
    """SAL stage of the pipeline: bi-intervals -> reference-coordinate seeds.

    Mirrors bwa's occurrence sampling: if an SMEM has s > max_occ hits, take
    every ceil(s/max_occ)-th row.  Seeds bridging a contig-block boundary
    (forward/reverse-complement junction, or any contig junction for a
    multi-contig index) are dropped (as in bwa).  The SA lookups run on
    ``device``: one gather (``sal_direct``), or with ``compressed`` the
    baseline's LF walk (``sal_compressed``, eta=32 occ or, with
    ``occ_eta32=False``, eta=128).

    Returns per-read list of seeds (rbeg, qbeg, len, interval_size) plus the
    total number of SA lookups performed (paper Table 5 "# SA offsets").
    """
    rows_all = []
    meta = []            # (read, qbeg, qend, s)
    for r, mems in enumerate(mems_per_read):
        for (k, l, s, qb, qe) in mems:
            step = s // max_occ if s > max_occ else 1
            cnt = 0
            kk = 0
            while kk < s and cnt < max_occ:
                rows_all.append(k + kk)
                meta.append((r, qb, qe, s))
                kk += step
                cnt += 1
    if not rows_all:
        return [[] for _ in mems_per_read], 0
    obs.count("sal_dispatches")
    obs.count("sal_rows", len(rows_all))
    fm = idx.device(device)
    rows = torch.from_numpy(np.asarray(rows_all, np.int64)).to(fm.sa.device)
    if compressed:
        vals, _ = sal_compressed(fm, rows, occ_eta32=occ_eta32)
    else:
        vals = sal_direct(fm, rows)
    vals = vals.cpu().numpy().astype(np.int64)
    edges = contig_edges(idx)
    slens = np.array([qe - qb for (_, qb, qe, _) in meta], np.int64)
    # one vectorized block test for the whole batch: a seed survives iff
    # rbeg and rbeg+slen-1 fall in the same contig block (the batched
    # form of core.contig.seed_within_contig — keep the predicates in sync)
    keep = np.searchsorted(edges, vals, side="right") == \
        np.searchsorted(edges, vals + slens - 1, side="right")
    out = [[] for _ in mems_per_read]
    for (r, qb, qe, s), rbeg, ok in zip(meta, vals.tolist(), keep.tolist()):
        if not ok:
            continue                      # bridges a contig-block boundary
        out[r].append((int(rbeg), qb, qe - qb, s))
    for r in range(len(out)):
        out[r].sort()
    return out, len(rows_all)
