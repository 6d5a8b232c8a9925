"""Banded Smith-Waterman seed extension (paper §5) — faithful ksw_extend2.

The scalar oracle ``bsw_extend`` is a direct port of bwa-0.7.x
``ksw_extend2`` (including band shrinking, z-drop, first-row/column
initialisation and the exact tie-breaking of max tracking).  It is the
output SPEC: every other implementation must match it bit-for-bit — the
``bsw`` CUDA kernel runs this loop one warp per task, a row in strips of
32 columns with F as the prefix max below.

``bsw_init_state``/``bsw_row_step`` are the plain PyTorch lockstep batch
(the counterpart of ``repro.core.bsw``'s): W tasks form the batch
dimension and every DP row is one vectorized step over tasks × columns,
with the in-row F recurrence written as a prefix max over
``t_j + (j+1)·e_ins``.  ``kernels.bsw.ref`` runs it as the plain version
of the kernel.

``pack_tasks`` lays a task list out as the padded (W, qmax)/(W, tmax)
arrays both take; ``bsw_extend_tasks`` is the length-sorted block driver
shared by the pipeline's executor; ``wasted_cell_stats`` counts the
useful and the computed DP cells of a blocking (the paper's Table 8).
The ``baseline`` engine runs ``bsw_extend`` itself, one task at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs

I32 = torch.int32
NEG = -(1 << 28)


@dataclasses.dataclass(frozen=True)
class BSWParams:
    """bwa-mem defaults."""
    a: int = 1            # match score
    b: int = 4            # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    w: int = 100          # band width
    zdrop: int = 100
    end_bonus: int = 5
    pen_clip5: int = 5
    pen_clip3: int = 5

    def matrix(self) -> np.ndarray:
        """5x5 scoring matrix; row/col 4 is the ambiguous base (-1)."""
        m = np.full((5, 5), -self.b, dtype=np.int32)
        np.fill_diagonal(m, self.a)
        m[4, :] = -1
        m[:, 4] = -1
        return m


@dataclasses.dataclass
class ExtResult:
    score: int
    qle: int
    tle: int
    gtle: int
    gscore: int
    max_off: int


def adjusted_band(qlen: int, p: BSWParams, w: int) -> int:
    """ksw_extend2's w-clamp from max possible indel length."""
    max_ins = int((qlen * p.a + p.end_bonus - p.o_ins) / p.e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w2 = min(w, max_ins)
    max_del = int((qlen * p.a + p.end_bonus - p.o_del) / p.e_del + 1.0)
    max_del = max(max_del, 1)
    return min(w2, max_del)


def bsw_extend(query: np.ndarray, target: np.ndarray, h0: int,
               p: BSWParams, w: int | None = None) -> ExtResult:
    """Scalar oracle — direct ksw_extend2 port. query/target: uint8 codes."""
    qlen, tlen = len(query), len(target)
    assert qlen > 0 and tlen > 0 and h0 > 0
    mat = p.matrix()
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins
    w = adjusted_band(qlen, p, p.w if w is None else w)

    # eh[j] = (h, e); h at loop start = H(i-1, j-1), e = E(i, j)
    eh_h = np.zeros(qlen + 2, dtype=np.int64)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)
    eh_h[0] = h0
    if qlen >= 1:
        eh_h[1] = max(h0 - oe_ins, 0)
    j = 2
    while j <= qlen and eh_h[j - 1] > p.e_ins:
        eh_h[j] = eh_h[j - 1] - p.e_ins
        j += 1

    max_ = h0
    max_i = max_j = -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        f = 0
        m = 0
        mj = -1
        trow = int(target[i])
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (p.o_del + p.e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for jj in range(beg, end):
            # eh[jj] = {H(i-1,jj-1), E(i,jj)}, f = F(i,jj), h1 = H(i,jj-1)
            M = int(eh_h[jj])
            e = int(eh_e[jj])
            eh_h[jj] = h1                      # H(i,jj-1) for next row
            M = M + int(mat[trow, int(query[jj])]) if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            mj = mj if m > h else jj           # last index attaining max
            m = m if m > h else h
            t = M - oe_del
            t = t if t > 0 else 0
            e -= p.e_del
            e = e if e > t else t
            eh_e[jj] = e                       # E(i+1,jj)
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= p.e_ins
            f = f if f > t else t
        eh_h[end] = h1
        eh_e[end] = 0
        if end == qlen:
            max_ie = max_ie if gscore > h1 else i
            gscore = gscore if gscore > h1 else h1
        if m == 0:
            break
        if m > max_:
            max_ = m
            max_i, max_j = i, mj
            off = abs(mj - i)
            max_off = max_off if max_off > off else off
        elif p.zdrop > 0:
            if (i - max_i) > (mj - max_j):
                if max_ - m - ((i - max_i) - (mj - max_j)) * p.e_del > p.zdrop:
                    break
            else:
                if max_ - m - ((mj - max_j) - (i - max_i)) * p.e_ins > p.zdrop:
                    break
        # band update for the next row
        jj = beg
        while jj < end and eh_h[jj] == 0 and eh_e[jj] == 0:
            jj += 1
        beg = jj
        jj = end
        while jj >= beg and eh_h[jj] == 0 and eh_e[jj] == 0:
            jj -= 1
        end = jj + 2 if jj + 2 < qlen else qlen
    return ExtResult(int(max_), max_j + 1, max_i + 1, max_ie + 1,
                     int(gscore), int(max_off))


# =====================================================================
# Plain PyTorch lockstep batch (tasks = batch dimension)
# =====================================================================

def _score_arith(tcode, qcode, a, b):
    """Gather-free scoring identical to BSWParams.matrix(): a on match,
    -b on mismatch, -1 if either code is ambiguous (>= 4)."""
    amb = (tcode >= 4) | (qcode >= 4)
    return torch.where(amb, -1, torch.where(tcode == qcode, a, -b)).to(I32)


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max along dim 1."""
    return torch.cummax(x, dim=1).values


def bsw_init_state(qlens, h0s, oe_ins, e_ins, qmax: int):
    """First-row fill: eh_h[0]=h0; eh_h[j>=1]=relu(h0-oe_ins-(j-1)e_ins)
    (values that would be <= 0 stay 0, matching the scalar early-exit)."""
    W = qlens.shape[0]
    dev = qlens.device
    jj = torch.arange(qmax + 1, dtype=I32, device=dev)
    fill = h0s[:, None] - oe_ins - (jj[None, :] - 1) * e_ins
    eh_h0 = torch.where(jj[None, :] == 0, h0s[:, None],
                        fill.clamp(min=0)).to(I32)
    eh_h0 = torch.where(jj[None, :] <= qlens[:, None], eh_h0, 0)
    eh_e0 = torch.zeros((W, qmax + 1), dtype=I32, device=dev)
    full = lambda v: torch.full((W,), v, dtype=I32, device=dev)
    return (eh_h0, eh_e0,
            full(0), qlens.to(I32),                        # beg, end
            h0s.to(I32),                                   # max
            full(-1), full(-1),                            # max_i, max_j
            full(-1), full(-1),                            # max_ie, gscore
            full(0),                                       # max_off
            torch.ones(W, dtype=torch.bool, device=dev))   # alive


def bsw_row_step(i: int, st, qs, ts, qlens, tlens, h0s, ws,
                 a, b, o_del, e_del, o_ins, e_ins, zdrop, qmax: int):
    """One DP row for all W tasks (bit-identical to the scalar oracle)."""
    (eh_h_st, eh_e_st, beg_st, end_st, max_st, max_i_st, max_j_st,
     max_ie_st, gscore_st, max_off_st, alive_st) = st
    W = qs.shape[0]
    dev = qs.device
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jj = torch.arange(qmax + 1, dtype=I32, device=dev)[None, :]  # eh index
    jq = jj[:, :qmax]                                            # query index

    act = alive_st & (i < tlens)
    beg = torch.maximum(beg_st, i - ws)
    end = torch.minimum(torch.minimum(end_st, i + ws + 1), qlens)
    h_first = torch.where(beg == 0,
                          (h0s - (o_del + e_del * (i + 1))).clamp(min=0), 0)
    trow = ts[:, i]                                          # (W,)
    srow = _score_arith(trow[:, None], qs, a, b)             # (W,qmax)
    in_band = (jq >= beg[:, None]) & (jq < end[:, None])
    Hd = eh_h_st[:, :qmax]                                   # H(i-1, j-1)
    Ec = eh_e_st[:, :qmax]                                   # E(i, j)
    Mq = torch.where(Hd != 0, Hd + srow, 0)
    Mq = torch.where(in_band, Mq, 0)
    Ec_b = torch.where(in_band, Ec, 0)
    # F scan (max-plus prefix): F_beg = 0; F_{j+1} = max(F_j - e, t_j)
    t_ins = (Mq - oe_ins).clamp(min=0)
    g = torch.where(in_band, t_ins + (jq + 1) * e_ins, NEG)
    cmax = _prefix_max(g)
    cmax_excl = torch.cat(
        [torch.full((W, 1), NEG, dtype=I32, device=dev), cmax[:, :-1]], dim=1)
    F = torch.maximum(cmax_excl, beg[:, None] * e_ins) - jq * e_ins
    H = torch.maximum(torch.maximum(Mq, Ec_b), F)
    H = torch.where(in_band, H, 0)
    # row max, LAST index attaining it (scalar tie-break)
    m = H.max(dim=1).values
    is_max = (H == m[:, None]) & in_band
    mj = torch.where(is_max, jq, -1).max(dim=1).values
    mj = torch.where(m > 0, mj, -1)
    # h1_final = H(i, end-1) (or first-col value if band empty)
    h_end = torch.where(jq == (end - 1)[:, None], H, NEG).max(dim=1).values
    h1_final = torch.where(end > beg, h_end, h_first)
    # E(i+1, j) and new stored arrays
    t_del = (Mq - oe_del).clamp(min=0)
    E_next = torch.maximum(Ec_b - e_del, t_del)
    # eh_h writes: position j in [beg, end] gets H(i, j-1); beg gets
    # h_first (beg==0) or 0; end gets H(i, end-1).
    zcol = torch.zeros((W, 1), dtype=I32, device=dev)
    Hshift = torch.cat([zcol, H], dim=1)                     # H(i, j-1) at j
    wr = (jj >= beg[:, None]) & (jj <= end[:, None])
    newh = torch.where(jj == beg[:, None], h_first[:, None], Hshift)
    newh = torch.where(jj == end[:, None], h1_final[:, None], newh)
    eh_h = torch.where(wr & act[:, None], newh, eh_h_st)
    Eword = torch.cat([E_next, zcol], dim=1)
    newe = torch.where(jj == end[:, None], 0, Eword)
    eh_e = torch.where(wr & act[:, None], newe, eh_e_st)
    # gscore bookkeeping (before the m==0 break, as in scalar code)
    at_end = act & (end == qlens)
    upd_g = at_end & ~(gscore_st > h1_final)
    max_ie = torch.where(upd_g, i, max_ie_st)
    gscore = torch.where(upd_g, h1_final, gscore_st)
    # m == 0 -> task stops (no max/zdrop updates)
    broke0 = act & (m == 0)
    cont = act & ~broke0
    better = cont & (m > max_st)
    off = (mj - i).abs()
    max_off = torch.where(better, torch.maximum(max_off_st, off), max_off_st)
    max_ = torch.where(better, m, max_st)
    max_i = torch.where(better, i, max_i_st)
    max_j = torch.where(better, mj, max_j_st)
    # z-drop
    di = i - max_i_st
    dj = mj - max_j_st
    zd = torch.where(di > dj,
                     max_st - m - (di - dj) * e_del,
                     max_st - m - (dj - di) * e_ins)
    zbreak = cont & ~better & (zdrop > 0) & (zd > zdrop)
    # band update (only tasks continuing past this row)
    nz = (eh_h != 0) | (eh_e != 0)
    cand = nz & (jj >= beg[:, None]) & (jj < end[:, None])
    beg_n = torch.where(cand, jj, qmax + 1).min(dim=1).values
    beg_n = torch.minimum(beg_n, end)
    cand2 = nz & (jj >= beg_n[:, None]) & (jj <= end[:, None])
    jstar = torch.where(cand2, jj, beg_n[:, None] - 1).max(dim=1).values
    end_n = torch.minimum(jstar + 2, qlens)
    keep = cont & ~zbreak
    if obs.enabled():
        obs.count("bsw_cells_banded",
                  int(((end - beg).clamp(min=0) * act).sum()))
        obs.count("bsw_task_rows", int(act.sum()))
    return (eh_h, eh_e,
            torch.where(keep, beg_n, beg_st),
            torch.where(keep, end_n, end_st),
            torch.where(cont, max_, max_st),
            torch.where(cont, max_i, max_i_st),
            torch.where(cont, max_j, max_j_st),
            max_ie, gscore,
            torch.where(cont, max_off, max_off_st),
            alive_st & keep)


def pack_tasks(queries, targets, h0s, p: BSWParams, ws=None,
               qmax: int | None = None, tmax: int | None = None):
    """Pad a task list to the kernel's layout: qs (W, qmax) and ts
    (W, tmax) int32 with pad code 4, and qlens, tlens, h0s and the
    ``adjusted_band`` of each task's w, all (W,) int32 numpy arrays."""
    W = len(queries)
    qlens = np.array([len(q) for q in queries], np.int32)
    tlens = np.array([len(t) for t in targets], np.int32)
    qmax = qmax or max(int(qlens.max(initial=0)), 1)
    tmax = tmax or max(int(tlens.max(initial=0)), 1)
    qs = np.full((W, qmax), 4, np.int32)
    ts = np.full((W, tmax), 4, np.int32)
    for i, (q, t) in enumerate(zip(queries, targets)):
        qs[i, :len(q)] = q
        ts[i, :len(t)] = t
    ws_in = np.array([adjusted_band(int(qlens[i]), p,
                                    p.w if ws is None else int(ws[i]))
                      for i in range(W)], np.int32)
    return qs, ts, qlens, tlens, np.asarray(h0s, np.int32).reshape(W), ws_in


def bsw_extend_tasks(queries, targets, h0s, p: BSWParams,
                     ws=None, *, batch_fn, block: int = 256, sort: bool = True,
                     pad: int = 32):
    """Batched driver for an ARBITRARY extension-task list (paper §5.3.1).

    The inter-task entry point shared by the pipeline's BSW stage and the
    paired-end mate-rescue fan-out: tasks are length-sorted, cut into
    lockstep blocks of ``block`` lanes, padded to a multiple of ``pad``
    and dispatched through ``batch_fn``.  Empty-query/target tasks
    short-circuit to the no-op result (ksw_extend is never called with
    empty sequences in bwa).

    ``batch_fn(queries, targets, h0s, p, ws=, qmax=, tmax=)`` runs one
    block and returns its ExtResults — the pipeline passes
    ``kernels.bsw.bsw_extend_kernel`` bound to its device.

    Returns (results in INPUT order, stats) where stats carries the
    Table-8-style useful/computed cell accounting.
    """
    n = len(queries)
    results: list = [None] * n
    stats = dict(tasks=0, cells_useful=0, cells_total=0)
    live = []
    for i in range(n):
        if len(queries[i]) == 0 or len(targets[i]) == 0:
            results[i] = ExtResult(h0s[i], 0, 0, 0, -1, 0)
        else:
            live.append(i)
    if not live:
        return results, stats
    qlens = np.array([len(queries[i]) for i in live])
    tlens = np.array([len(targets[i]) for i in live])
    order = sort_tasks_by_length(qlens, tlens) if sort \
        else np.arange(len(live))
    for s in range(0, len(live), block):
        idxs = [live[j] for j in order[s:s + block]]
        qs = [queries[i] for i in idxs]
        ts = [targets[i] for i in idxs]
        h0b = [h0s[i] for i in idxs]
        wsb = None if ws is None else [ws[i] for i in idxs]
        qmax = -(-max(len(q) for q in qs) // pad) * pad
        tmax = -(-max(len(t) for t in ts) // pad) * pad
        res = batch_fn(qs, ts, h0b, p, ws=wsb, qmax=qmax, tmax=tmax)
        for i, r in zip(idxs, res):
            results[i] = r
        obs.count("bsw_dispatches")
        stats["tasks"] += len(idxs)
        stats["cells_useful"] += int((np.array([len(q) for q in qs]) *
                                      np.array([len(t) for t in ts])).sum())
        stats["cells_total"] += qmax * tmax * len(idxs)
    return results, stats


def sort_tasks_by_length(qlens: np.ndarray, tlens: np.ndarray) -> np.ndarray:
    """Paper §5.3.1: sort tasks by length so same-block lanes are uniform.

    Radix-style two-key sort (target-major) returning the permutation.
    """
    return np.lexsort((np.asarray(qlens), np.asarray(tlens)))


def wasted_cell_stats(qlens, tlens, order, block: int = 128):
    """Table-8-style accounting: useful vs computed DP cells per block."""
    qlens = np.asarray(qlens)[order]
    tlens = np.asarray(tlens)[order]
    total = useful = 0
    for s in range(0, len(qlens), block):
        qb = qlens[s:s + block]
        tb = tlens[s:s + block]
        total += int(qb.max()) * int(tb.max()) * len(qb)
        useful += int((qb * tb).sum())
    return useful, total
