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
arrays both take; ``bsw_extend_wave`` is the length-sorted driver of
one wave of tasks given as arrays (the pipeline's executor sends each
wave in one call), ``bsw_extend_tasks`` the same over a task list;
``wasted_cell_stats`` counts the useful and the computed DP cells of a
blocking (the paper's Table 8).
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
    ``adjusted_band`` of each task's w, all (W,) int32 numpy arrays
    (``stage_tasks`` then ``unstage_tasks`` on the host)."""
    buf, qlens, tlens = stage_tasks(queries, targets, h0s, p, ws)
    return tuple(t.numpy() for t in unstage_tasks(
        torch.from_numpy(buf), qlens, tlens, qmax, tmax))


def stage_tasks(queries, targets, h0s, p: BSWParams, ws=None, *,
                alloc=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A task list (codes 0..4) as ONE flat byte buffer: the int32 qlens,
    tlens, h0s and ``adjusted_band`` of each task's w (``p.w`` where
    ``ws`` is None), then every query's codes and every target's, a byte
    each, then one pad code 4.  ``alloc(n)`` gives the buffer (a reused
    pinned one), by default a new array.  Returns (the buffer, qlens,
    tlens); ``unstage_tasks`` lays it out as the kernel's arrays."""
    W = len(queries)
    qlens = np.fromiter(map(len, queries), np.int64, W)
    tlens = np.fromiter(map(len, targets), np.int64, W)
    nq, nt = int(qlens.sum()), int(tlens.sum())
    n = 16 * W + nq + nt + 1
    buf = np.empty(n, np.uint8) if alloc is None else alloc(n)[:n]
    ints = buf[:16 * W].view(np.int32).reshape(4, W)
    ints[0] = qlens
    ints[1] = tlens
    ints[2] = np.asarray(h0s).reshape(W)
    ints[3] = adjusted_bands(qlens, p, p.w if ws is None else
                             np.asarray(ws).reshape(W))
    if W:
        np.concatenate(queries, out=buf[16 * W:16 * W + nq],
                       casting="unsafe")
        np.concatenate(targets, out=buf[16 * W + nq:n - 1],
                       casting="unsafe")
    buf[n - 1] = 4
    return buf, qlens, tlens


def unstage_tasks(buf: torch.Tensor, qlens: np.ndarray, tlens: np.ndarray,
                  qmax: int | None = None, tmax: int | None = None):
    """``stage_tasks``'s buffer, on any device, as the kernel's arrays
    there: qs (W, qmax) and ts (W, tmax) int32, each row its codes then
    pad code 4 (one gather a side), and the (W,) int32 qlens, tlens, h0s
    and ws (views of the buffer).  ``qlens``/``tlens`` are the host's
    copies, for the widths and offsets: nothing waits for the device."""
    W = len(qlens)
    qmax = qmax or max(int(qlens.max(initial=0)), 1)
    tmax = tmax or max(int(tlens.max(initial=0)), 1)
    if qlens.max(initial=0) > qmax or tlens.max(initial=0) > tmax:
        raise ValueError(f"bsw: a task is longer than qmax {qmax} or tmax "
                         f"{tmax}")
    ints = buf[:16 * W].view(torch.int32).view(4, W)
    seq = buf[16 * W:]
    pad = len(seq) - 1

    def padded(lens: torch.Tensor, base: int, width: int) -> torch.Tensor:
        lens = lens.long()
        off = torch.cumsum(lens, 0) - lens + base
        col = torch.arange(width, device=buf.device)
        src = torch.where(col < lens[:, None], off[:, None] + col, pad)
        return seq[src].int()
    return (padded(ints[0], 0, qmax), padded(ints[1], int(qlens.sum()), tmax),
            ints[0], ints[1], ints[2], ints[3])


def adjusted_bands(qlens, p: BSWParams, ws) -> np.ndarray:
    """``adjusted_band`` of every task at once: ``qlens`` and ``ws``
    (an array or one width for all) -> the clamped widths, int64."""
    qa = np.asarray(qlens, np.int64) * p.a + p.end_bonus
    max_ins = np.maximum(np.trunc((qa - p.o_ins) / p.e_ins + 1.0), 1)
    max_del = np.maximum(np.trunc((qa - p.o_del) / p.e_del + 1.0), 1)
    return np.minimum(np.asarray(ws, np.int64),
                      np.minimum(max_ins, max_del).astype(np.int64))


def bsw_extend_wave(seqs, qlens, tlens, h0s, ws, p: BSWParams, *,
                    batch_fn, sort: bool = True,
                    pad: int = 32) -> tuple[np.ndarray, dict]:
    """Batched driver of one wave of n extension tasks (paper §5.3.1),
    given as arrays: ``qlens``, ``tlens``, ``h0s``, ``ws`` (n,).

    Tasks with an empty query or target short-circuit to the no-op
    result (ksw_extend is never called with empty sequences in bwa).
    The live ones are length-sorted by (tlen, qlen) and sent through
    ``batch_fn`` in ONE call, padded to a multiple of ``pad``.
    ``seqs(i)`` gives the (queries, targets) sequences of the tasks
    ``i`` (an index array, in launch order).

    ``batch_fn(queries, targets, h0s, p, ws=, qmax=, tmax=)`` returns
    the call's (6, W) results (a replacement may return one ExtResult a
    task): the pipeline passes ``kernels.bsw.bsw_extend_kernel`` bound
    to its device.

    Returns ((6, n) int64 rows score, qle, tle, gtle, gscore, max_off in
    INPUT order, stats) where stats carries the Table-8-style cell
    accounting: ``cells_useful`` the tasks' qlen x tlen, ``cells_total``
    the padded (W, qmax) x (W, tmax) layout the call sends."""
    qlens, tlens = np.asarray(qlens), np.asarray(tlens)
    h0s, ws = np.asarray(h0s), np.asarray(ws)
    n = len(qlens)
    out = np.zeros((6, n), np.int64)     # the no-op result:
    out[0] = h0s                         # ExtResult(h0, 0, 0, 0, -1, 0)
    out[4] = -1
    stats = dict(tasks=0, cells_useful=0, cells_total=0)
    i = np.flatnonzero((qlens > 0) & (tlens > 0))
    if not len(i):
        return out, stats
    if sort:
        i = i[sort_tasks_by_length(qlens[i], tlens[i])]
    with obs.span("bsw.pack"):
        qs, ts = seqs(i)
    ql, tl = qlens[i], tlens[i]
    qmax = -(-int(ql.max()) // pad) * pad
    tmax = -(-int(tl.max()) // pad) * pad
    res = batch_fn(qs, ts, h0s[i], p, ws=ws[i], qmax=qmax, tmax=tmax)
    out[:, i] = res if isinstance(res, np.ndarray) else np.array(
        [(r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off)
         for r in res], np.int64).reshape(-1, 6).T
    obs.count("bsw_dispatches")
    stats["tasks"] = len(i)
    stats["cells_useful"] = int((ql * tl).sum())
    stats["cells_total"] = qmax * tmax * len(i)
    return out, stats


def bsw_extend_tasks(queries, targets, h0s, p: BSWParams,
                     ws=None, *, batch_fn, block: int = 256, sort: bool = True,
                     pad: int = 32):
    """``bsw_extend_wave`` over an ARBITRARY extension-task list: the
    tasks' sequences, ``h0s`` and ``ws`` (None: ``p.w`` for all) as
    lists; the live tasks length-sorted and cut into calls of at most
    ``block`` tasks.

    Returns (ExtResults in INPUT order, stats)."""
    n = len(queries)
    qlens = np.fromiter(map(len, queries), np.int64, n)
    tlens = np.fromiter(map(len, targets), np.int64, n)
    h0s = np.asarray(h0s, np.int64).reshape(n)
    ws = np.full(n, p.w) if ws is None else np.asarray(ws, np.int64)
    live = (qlens > 0) & (tlens > 0)
    order = np.flatnonzero(live)
    if sort:
        order = order[sort_tasks_by_length(qlens[order], tlens[order])]
    out = np.empty((6, n), np.int64)
    stats = dict(tasks=0, cells_useful=0, cells_total=0)
    # the empty tasks short-circuit without a call, then the blocks
    for i in [np.flatnonzero(~live)] + [order[s:s + block]
                                        for s in range(0, len(order), block)]:
        out[:, i], st = bsw_extend_wave(
            lambda k, i=i: ([queries[j] for j in i[k]],
                            [targets[j] for j in i[k]]),
            qlens[i], tlens[i], h0s[i], ws[i], p, batch_fn=batch_fn,
            sort=False, pad=pad)
        stats = {k: v + st[k] for k, v in stats.items()}
    return [ExtResult(*r) for r in out.T.tolist()], stats


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
