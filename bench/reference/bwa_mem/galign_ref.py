"""Plain PyTorch version of the galign kernel: ``core.sam.
global_align_cigar`` (banded global alignment with affine gaps and
traceback) for a batch of tasks, with the kernel's padded array
interface.

It runs the same recurrences on the same integers, vectorised over the
tasks and over a row's columns: one step a DP row, in which E, the gap
along the row, comes from an exclusive prefix maximum (``cummax``), and
one step a traceback move.  Each cell keeps the traceback's three
decisions as bits (``hdir``: which of M, E and F the cell's H equals
first; ``eclose`` and ``fclose``: whether its E or F equals the gap
opened from the H before it), so the traceback replays the reference's
equality tests without the H, E and F matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from .bsw import BSWParams

#: the reference's "minus infinity": cells outside the band hold it, and
#: the recurrences compute on it as on any score
NEG = -(1 << 28)
#: run ops, as indices into ``core.sam._OPS`` ("MID")
OP_M, OP_I, OP_D = 0, 1, 2
_FLOOR = -(1 << 60)                 # below every value a row can hold


def band(ns, ms, ws):
    """The reference's band half-width: ``max(w, |n - m| + 3)``."""
    return torch.maximum(ws, (ns - ms).abs() + 3)


def edge_case(n: int, m: int, p: BSWParams):
    """``(score, runs)`` of a task with an empty query or target, as the
    reference returns them, or None for any other task."""
    if n == 0:
        return (-p.o_del - p.e_del * m if m else 0), ([(m, OP_D)] if m else [])
    if m == 0:
        return -p.o_ins - p.e_ins * n, [(n, OP_I)]
    return None


def pack_runs(runs_per_task: list, T: int, stride: int):
    """``(nruns (T,), runs (T, stride))`` int32, a run as
    ``count << 2 | op``."""
    nruns = np.zeros(T, np.int32)
    runs = np.zeros((T, max(stride, 1)), np.int32)
    for t, rl in enumerate(runs_per_task):
        nruns[t] = len(rl)
        for k, (c, op) in enumerate(rl):
            runs[t, k] = (c << 2) | op
    return torch.from_numpy(nruns), torch.from_numpy(runs)


def galign_ref(qs: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor,
               ms: torch.Tensor, ws: torch.Tensor, p: BSWParams):
    """qs (T, nmax) / ts (T, mmax) codes 0..4 (any pad); ns, ms, ws (T,)
    int32 -> (score (T,), nruns (T,), runs (T, max(n + m))) int32, a run
    ``count << 2 | op`` with op 0 M, 1 I, 2 D, in CIGAR order.  A task
    whose traceback would leave the band gets ``nruns`` -1 (the wrapper
    raises): the reference cannot do so, since every cell in the band
    holds a score and every cell outside it only the reference's NEG."""
    T, dev = qs.shape[0], qs.device
    n, m = ns.long(), ms.long()
    w = band(n, m, ws.long())
    q, t = qs.long(), ts.long()
    nmax = int(n.max()) if T else 0
    mmax = int(m.max()) if T else 0
    stride = int((n + m).max()) if T else 0
    oe_del, oe_ins = p.o_del + p.e_del, p.o_ins + p.e_ins
    d = p.e_del + min(0, p.o_del)   # E's decay along a row (see galign.cu)
    mat = torch.as_tensor(p.matrix(), dtype=torch.int64, device=dev)
    J = torch.arange(mmax + 1, device=dev)
    col = J[None, :]
    # row 0 and the first column, as far as the reference initialises them
    H = torch.where((col >= 1) & (col <= torch.minimum(m, w)[:, None]),
                    -(p.o_del + p.e_del * col), NEG)
    H[:, 0] = 0
    F = torch.full_like(H, NEG)
    bits = torch.zeros((T, nmax + 1, mmax + 1), dtype=torch.uint8,
                       device=dev)
    neg_col = torch.full((T, 1), NEG, dtype=torch.int64, device=dev)
    floor_col = torch.full((T, 1), _FLOOR, dtype=torch.int64, device=dev)
    for i in range(1, nmax + 1):
        live = i <= n
        jlo = torch.clamp_min(i - w, 1)
        jhi = torch.minimum(m, i + w)
        inb = (col >= jlo[:, None]) & (col <= jhi[:, None]) & live[:, None]
        first = torch.where(i <= torch.minimum(n, w),
                            -(p.o_ins + p.e_ins * i), NEG)    # H[i, 0]
        sc = mat[q[:, i - 1][:, None], t[:, :mmax]] if mmax else \
            torch.zeros((T, 0), dtype=torch.int64, device=dev)
        diag = torch.cat([neg_col, H[:, :-1] + sc], dim=1)
        Fn = torch.maximum(F - p.e_ins, H - oe_ins)
        Hp = torch.maximum(diag, Fn)
        hleft = torch.where(jlo == 1, first, NEG)                # H[i, jlo-1]
        e_lo = torch.maximum(torch.full_like(hleft, NEG - p.e_del),
                             hleft - oe_del)                    # E[i, jlo]
        A = torch.where(inb, Hp - oe_del + d * (col + 1), _FLOOR)
        before = torch.cat([floor_col, torch.cummax(A, dim=1).values[:, :-1]],
                           dim=1)
        E = torch.maximum((e_lo + d * jlo)[:, None], before) - d * col
        Hn = torch.maximum(Hp, E)
        Hrow = torch.where(inb, Hn, NEG)
        Hrow[:, 0] = first
        eclose = E == torch.cat([neg_col, Hrow[:, :-1]], dim=1) - oe_del
        fclose = Fn == H - oe_ins
        hdir = torch.where(Hn == diag, 0, torch.where(
            Hn == E, 1, torch.where(Hn == Fn, 2, 3)))
        b = hdir | (eclose.long() << 2) | (fclose.long() << 3)
        bits[:, i] = torch.where(inb, b, 0).to(torch.uint8)
        H = torch.where(live[:, None], Hrow, H)
        F = torch.where(live[:, None], torch.where(inb, Fn, NEG), F)
    score = H[torch.arange(T, device=dev), m].cpu()
    ops, cnt, bad = (x.cpu() for x in _traceback(bits, n, m, w))
    n, m = n.cpu(), m.cpu()
    runs_per_task = []
    for k in range(T):
        edge = edge_case(int(n[k]), int(m[k]), p)
        if edge is not None:
            score[k] = edge[0]
            runs_per_task.append(edge[1])
            continue
        if bad[k]:
            runs_per_task.append(None)
            continue
        seq = ops[k, :cnt[k]].numpy()[::-1]
        cut = np.flatnonzero(np.diff(seq)) + 1
        starts = np.concatenate([[0], cut])
        lens = np.diff(np.concatenate([starts, [len(seq)]]))
        runs_per_task.append([(int(c), int(seq[s]))
                              for s, c in zip(starts, lens)])
    nruns, runs = pack_runs([r or [] for r in runs_per_task], T, stride)
    nruns[[k for k, r in enumerate(runs_per_task) if r is None]] = -1
    return score.to(torch.int32).to(dev), nruns.to(dev), runs.to(dev)


def _traceback(bits, n, m, w):
    """All tasks' tracebacks, one move a step: ``(ops (T, steps) in
    traceback order, counts (T,), bad (T,))``.  In state H a cell's
    ``hdir`` picks M (or, never in the band, the reference's corner
    branch, which also emits M where i, j > 0), or a switch to E or F; E
    emits D and F emits I, returning to H on ``eclose`` / ``fclose``.
    Row 0 is all D and column 0 all I, whatever the state, as in the
    reference; E at column 0, F at row 0 or a cell off the band would
    take the reference into its NEG cells, and marks the task bad."""
    T, dev = bits.shape[0], bits.device
    i, j = n.clone(), m.clone()
    st = torch.zeros(T, dtype=torch.int64, device=dev)   # 0 H, 1 E, 2 F
    ar = torch.arange(T, device=dev)
    cap = 2 * int((n + m).max()) + 2 if T else 0
    ops = torch.zeros((T, cap), dtype=torch.int8, device=dev)
    cnt = torch.zeros(T, dtype=torch.int64, device=dev)
    bad = torch.zeros(T, dtype=torch.bool, device=dev)
    live = ((i > 0) | (j > 0)) & (n > 0) & (m > 0)
    while bool(live.any()):
        row0 = live & (i == 0)
        col0 = live & (i > 0) & (j == 0)
        inner = live & (i > 0) & (j > 0)
        onband = (inner & (j >= torch.clamp_min(i - w, 1))
                  & (j <= torch.minimum(m, i + w)))
        bad |= (inner & ~onband) | (row0 & (st == 2)) | (col0 & (st == 1))
        live &= ~bad
        b = bits[ar, i.clamp(0, bits.shape[1] - 1),
                 j.clamp(0, bits.shape[2] - 1)].long()
        hdir, ecl, fcl = b & 3, (b >> 2) & 1, (b >> 3) & 1
        inner = live & (i > 0) & (j > 0)
        h = inner & (st == 0)
        diag = h & ((hdir == 0) | (hdir == 3))
        dele = (live & (i == 0)) | (inner & (st == 1))
        ins = (live & (i > 0) & (j == 0)) | (inner & (st == 2))
        emit = diag | dele | ins
        op = torch.where(diag, OP_M, torch.where(dele, OP_D, OP_I))
        ops[ar[emit], cnt[emit]] = op[emit].to(torch.int8)
        cnt += emit.long()
        nst = torch.where(h & (hdir == 1), 1, torch.where(h & (hdir == 2),
                                                           2, st))
        nst = torch.where(inner & (st == 1), torch.where(ecl == 1, 0, 1), nst)
        nst = torch.where(inner & (st == 2), torch.where(fcl == 1, 0, 2), nst)
        st = torch.where(live, nst, st)
        i = i - (diag | ins).long()
        j = j - (diag | dele).long()
        live &= (i > 0) | (j > 0)
    return ops, cnt, bad
