"""The work of the port's three kernels, counted from their inputs, and
the card's peaks: the least time each launch could take.

Copied from ``chip_smoke.py`` (``ext_bound_ms``, ``bsw_bound_ms``,
``galign_cells``, ``galign_bound_ms``); the BSW cells are counted by the
reference's frozen banded recurrence (``bsw.bsw_row_step``), not by the
port's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

#: HBM bandwidth of one H100 SXM (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
#: int32 operations a second, derived (not on the data sheet): an SM
#: issues 64 int32 lanes a clock, 132 SMs, 1.98 GHz boost
INT32_OPS_PER_S = 64 * 132 * 1.98e9
#: int32 ALU operations per banded DP cell of ksw_extend2 (score 4, M 3,
#: h 2, row max 3, E 4, F 4)
BSW_OPS_PER_CELL = 20
#: int32 ALU operations per banded DP cell of the global alignment (E 3,
#: F 3, the diagonal with its score 3, H 2)
GALIGN_OPS_PER_CELL = 11
SECTOR = 32                         # DRAM access granularity in bytes


def ext_bound_s(st: torch.Tensor, which: str, layout: str) -> float:
    """Least time of one SMEM round on the (4, n) entries ``st`` (k, l,
    s, c): 28 bytes an entry read and written once, plus every distinct
    32-byte sector of the count table and every distinct bucket row that
    the entries' two positions touch, over the HBM rate."""
    shift = 5 if layout == "eta32" else 7
    k = st[0] if which == "bwd" else st[1]
    b = torch.cat([k, k + st[2]]) >> shift
    count_sectors = torch.unique(b >> 1).numel()   # 16 B of counts a bucket
    rows = torch.unique(b).numel()                 # one 32-B row a bucket
    return (28 * st.shape[1] + SECTOR * (count_sectors + rows)) \
        / HBM_BYTES_PER_S


def bsw_cells_each(queries, targets, h0s, ws, p, device,
                   block: int = 8192) -> np.ndarray:
    """Banded DP cells of each extension task (query, target, h0, w),
    row by row through the reference's frozen recurrence
    (``bsw.bsw_row_step``): a row's cells are its band [beg, end) while
    the task is alive, as ``bsw_cells_banded`` counts them."""
    from ..reference.bwa_mem.bsw import (bsw_init_state, bsw_row_step,
                                         pack_tasks)
    out = np.zeros(len(queries), np.int64)
    order = np.lexsort(([len(q) for q in queries],
                        [len(t) for t in targets]))
    for s0 in range(0, len(order), block):
        sel = order[s0:s0 + block]
        packed = pack_tasks([queries[i] for i in sel],
                            [targets[i] for i in sel],
                            [h0s[i] for i in sel], p, [ws[i] for i in sel])
        qs, ts, ql, tl, h0, w = (torch.from_numpy(a).to(device)
                                 for a in packed)
        qmax = qs.shape[1]
        st = bsw_init_state(ql, h0, p.o_ins + p.e_ins, p.e_ins, qmax)
        acc = torch.zeros(len(sel), dtype=torch.int64, device=device)
        for i in range(ts.shape[1]):
            act = st[-1] & (i < tl)
            if not bool(act.any()):
                break
            beg = torch.maximum(st[2], i - w)
            end = torch.minimum(torch.minimum(st[3], i + w + 1), ql)
            acc += (end - beg).clamp(min=0) * act
            st = bsw_row_step(i, st, qs, ts, ql, tl, h0, w, p.a, p.b,
                              p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop,
                              qmax)
        out[sel] = acc.cpu().numpy()
    return out


def bsw_bound_s(cells: int, W: int, qmax: int, tmax: int) -> float:
    """Least time of one BSW block: its cells x ``BSW_OPS_PER_CELL``
    over the int32 rate, or its packed inputs (W x (qmax + tmax + 4)
    int32) read and its (6, W) int32 output written once over the HBM
    rate, whichever is longer."""
    nbytes = 4 * W * (qmax + tmax + 4) + 4 * 6 * W
    return max(cells * BSW_OPS_PER_CELL / INT32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def galign_cells(tasks) -> int:
    """Banded DP cells of ``(q, t, w)`` tasks: each row's [max(1, i - w),
    min(m, i + w)] with the reference's w = max(w, |n - m| + 3)."""
    total = 0
    for q, t, w in tasks:
        n, m = len(q), len(t)
        if n and m:
            w = max(w, abs(n - m) + 3)
            i = np.arange(1, n + 1)
            total += int(np.maximum(0, np.minimum(m, i + w)
                                    - np.maximum(1, i - w) + 1).sum())
    return total


def galign_bound_s(tasks, cells: int, runs: int) -> float:
    """Least time of one galign call: its cells x ``GALIGN_OPS_PER_CELL``
    over the int32 rate, or every input (codes, n, m, w) read and every
    output (score, run count, ``runs`` runs) written once over the HBM
    rate, whichever is longer."""
    nbytes = (sum(len(q) + len(t) for q, t, _ in tasks) + 12 * len(tasks)
              + 8 * len(tasks) + 4 * runs)
    return max(cells * GALIGN_OPS_PER_CELL / INT32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)
