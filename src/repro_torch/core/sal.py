"""Suffix-array lookup (SAL) — paper §4.5.

The PyTorch counterpart of ``repro.core.sal``:

* ``sal_direct``    — optimized: one gather from the UNCOMPRESSED suffix
                      array (Equation 1, ``j = S[i]``); the paper's 183x fix.
* ``sal_compressed``— baseline: original BWA-MEM behaviour, LF-mapping walk
                      over the FM-index until a sampled row is reached
                      (~5000 instructions/lookup in the paper's Table 5),
                      as plain torch ops on the index's device.

Both are batched over all lookups of a read batch (Fig-2 stage-major
workflow) and produce identical values.  The ``baseline`` engine walks
one lookup at a time on the host instead
(``FMIndex.sa_lookup_compressed``), as the original does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..kernels import build
from .contig import contig_edges
from .fmindex import (FMArrays, I32, SA_SAMPLE, SENTINEL, occ_base_v,
                      occ_opt_v)


#: devices on which the SAL gather has launched once outside the gate
_GATHER_LOADED: set = set()


def sal_direct(fm: FMArrays, rows: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """rows (T,) int64 on fm's device -> SA values (T,) int32. One gather,
    into ``out`` when given."""
    return torch.gather(fm.sa, 0, rows, out=out)


def _sal_timed(fm: FMArrays, rows: torch.Tensor) -> torch.Tensor:
    """``sal_direct`` on a CUDA device, timed by CUDA events as
    ``time_device_sal_s`` under the launch gate.  Nothing inside the gate
    may wait for the device: the output is allocated before it, and the
    gather's first launch on a device runs outside it, since a lazily
    loaded kernel's first launch waits for the device."""
    out = torch.empty(rows.shape, dtype=fm.sa.dtype, device=rows.device)
    if rows.device not in _GATHER_LOADED:
        sal_direct(fm, rows[:1], out=out[:1])
        _GATHER_LOADED.add(rows.device)
    with obs.device_span("sal", rows.device, build.GATE):
        return sal_direct(fm, rows, out=out)


def sal_compressed(fm: FMArrays, rows: torch.Tensor, occ_eta32: bool = True):
    """Baseline compressed-SA lookup: per-row LF walk until a sampled row.

    rows (T,) on fm's device -> (values (T,) int32, steps (T,) int32),
    on that device.  The walk is inherently sequential per lookup —
    batching across lookups is the only parallelism (which is exactly
    how the original runs it on one core: one at a time).  Every row
    takes a step a round until every lookup is done; the occ lookups
    go through the eta=32 layout or, with ``occ_eta32=False``, the
    eta=128 one.
    """
    occ = occ_opt_v if occ_eta32 else occ_base_v
    T = rows.shape[0]
    dev = fm.sa.device
    j = rows.to(device=dev, dtype=I32)
    t = torch.zeros(T, dtype=I32, device=dev)
    val = torch.zeros(T, dtype=I32, device=dev)
    done = torch.zeros(T, dtype=torch.bool, device=dev)
    while not bool(done.all()):
        sampled = (j % SA_SAMPLE) == 0
        now_sampled = ~done & sampled
        val = torch.where(now_sampled,
                          fm.sa_sampled[(j // SA_SAMPLE).long()] + t, val)
        done2 = done | now_sampled
        b = fm.bwt[torch.minimum(j.clamp_min(0), fm.N - 1).long()].to(I32)
        hit_sent = ~done2 & (b == SENTINEL)
        val = torch.where(hit_sent, t % fm.N, val)
        done = done2 | hit_sent
        stepping = ~done
        bc = torch.clamp(b, 0, 3)
        lf = fm.C[bc.long()] + occ(fm, bc, j - 1)
        j = torch.where(stepping, lf, j)
        t = torch.where(stepping, t + 1, t)
    return val, t


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
    elif rows.is_cuda:
        vals = _sal_timed(fm, rows)
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
