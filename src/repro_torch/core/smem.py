"""SMEM search (paper §2.3/§4.2, Algorithms 2-4; faithful port of bwa smem1).

The PyTorch counterpart of ``repro.core.smem``.  Two implementations
with IDENTICAL output (the paper's hard requirement):

* ``smem1`` / ``seed_strategy1`` / ``collect_smems`` — scalar oracle,
  a direct port of bwa-0.7.x ``bwt_smem1a`` / ``bwt_seed_strategy1`` /
  ``mem_collect_intv`` semantics over the host's ``FMIndex.occ``; the
  ``baseline`` engine's seeding.

* ``smem1_batch`` / ``seed_strategy1_batch`` / ``collect_smems_batch`` —
  the paper's *batched* reorganization (§3.1 + §4.3): many independent
  (read, start-position) SMEM tasks advance in lockstep rounds; each round
  performs ONE vectorized backward/forward extension for every live task.
  The state stays on the host in numpy, compact: flat arrays of the live
  entries and of the live tasks, so a round's host work follows its live
  entries.  Each round sends them — the ones whose results the loop
  reads — to the index's device as one (4, n) int32 (k, l, s, c) tensor,
  runs the whole extension there (``kernels.fmocc.ext_round``: one launch
  of the fused round kernel, every occ lookup inside it) and brings
  (3, n) (k', l', s') back in one copy — one device round trip per round.

An SMEM is reported as (k, l, s, qbeg, qend): bi-interval + query span.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..kernels.fmocc.ops import OccConfig, ext_round
from .fmindex import FMIndex


@dataclasses.dataclass(frozen=True)
class MemOptions:
    """Seeding options (bwa-mem defaults)."""
    min_seed_len: int = 19
    split_factor: float = 1.5
    split_width: int = 10
    max_mem_intv: int = 20
    max_occ: int = 500        # max SA occurrences sampled per SMEM

    @property
    def split_len(self) -> int:
        return int(self.min_seed_len * self.split_factor + 0.499)


def frac_rep(mems, l_query: int, max_occ: int) -> float:
    """bwa mem_chain's per-read repeat fraction: the fraction of the read
    covered by SMEMs whose interval size exceeds ``max_occ`` (union of
    query spans, walked in the collectors' sorted (qbeg, qend) order).
    Feeds the q_pe scaling term of the pair-aware MAPQ blend
    (``pe.pairing.blend_mapq``)."""
    b = e = l_rep = 0
    for (k, l, s, qb, qe) in mems:
        if s <= max_occ:
            continue
        if qb > e:
            l_rep += e - b
            b, e = qb, qe
        else:
            e = max(e, qe)
    l_rep += e - b
    return l_rep / l_query if l_query else 0.0


# =====================================================================
# Scalar oracle (port of bwt_smem1a with max_intv=0)
# =====================================================================

def smem1(idx: FMIndex, q: np.ndarray, x: int, min_intv: int = 1):
    """All SMEMs overlapping position x. Returns (smems, ret).

    smems: list of (k, l, s, qbeg, qend); ret: next start position for the
    caller's x-loop (end of the longest forward extension from x).
    """
    L = len(q)
    if q[x] > 3:
        return [], x + 1
    min_intv = max(min_intv, 1)
    ik = idx.init_interval(int(q[x]))
    ik_end = x + 1
    curr: list[tuple[int, int, int, int]] = []   # (k, l, s, end)
    i = x + 1
    broke = False
    while i < L:
        b = int(q[i])
        if b > 3:                       # ambiguous base: stop fwd extension
            curr.append((*ik, ik_end))
            broke = True
            break
        ok = idx.forward_ext(*ik, b)
        if ok[2] != ik[2]:              # interval size changed
            curr.append((*ik, ik_end))
            if ok[2] < min_intv:
                broke = True
                break
        ik = ok
        ik_end = i + 1
        i += 1
    if not broke:
        curr.append((*ik, ik_end))
    curr.reverse()                      # longest forward match first
    ret = curr[0][3]

    prev = curr
    mems: list[tuple[int, int, int, int, int]] = []
    i = x - 1
    while i >= -1:
        c = -1 if (i < 0 or q[i] > 3) else int(q[i])
        curr = []
        for (k, l, s, end) in prev:
            ok = idx.backward_ext(k, l, s, c) if c >= 0 else (0, 0, 0)
            if c < 0 or ok[2] < min_intv:
                if not curr:            # no longer match survived this round
                    if not mems or i + 1 < mems[-1][3]:
                        mems.append((k, l, s, i + 1, end))
            elif not curr or ok[2] != curr[-1][2]:
                curr.append((ok[0], ok[1], ok[2], end))
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()                      # sorted by start coordinate
    return mems, ret


def seed_strategy1(idx: FMIndex, q: np.ndarray, x: int, min_len: int,
                   max_intv: int):
    """Port of bwt_seed_strategy1 (bwa's 3rd seeding round). -> (mem|None, ret)."""
    L = len(q)
    if q[x] > 3:
        return None, x + 1
    ik = idx.init_interval(int(q[x]))
    for i in range(x + 1, L):
        b = int(q[i])
        if b > 3:
            return None, i + 1
        ok = idx.forward_ext(*ik, b)
        if ok[2] < max_intv and i - x >= min_len:
            if ok[2] > 0:
                return (ok[0], ok[1], ok[2], x, i + 1), i + 1
            return None, i + 1
        ik = ok
    return None, L


def collect_smems(idx: FMIndex, q: np.ndarray, opt: MemOptions):
    """Port of mem_collect_intv: 3 seeding passes; sorted (qbeg,qend) order."""
    L = len(q)
    mem: list[tuple[int, int, int, int, int]] = []
    # pass 1: all SMEMs
    x = 0
    while x < L:
        if q[x] < 4:
            ms, x = smem1(idx, q, x, 1)
            mem.extend(m for m in ms if m[4] - m[3] >= opt.min_seed_len)
        else:
            x += 1
    # pass 2: re-seed long, low-occurrence SMEMs
    old = list(mem)
    for (k, l, s, qb, qe) in old:
        if qe - qb < opt.split_len or s > opt.split_width:
            continue
        ms, _ = smem1(idx, q, (qb + qe) >> 1, s + 1)
        mem.extend(m for m in ms if m[4] - m[3] >= opt.min_seed_len)
    # pass 3: LAST-like forward-only seeds
    if opt.max_mem_intv > 0:
        x = 0
        while x < L:
            if q[x] < 4:
                m, x = seed_strategy1(idx, q, x, opt.min_seed_len,
                                      opt.max_mem_intv)
                if m is not None:
                    mem.append(m)
            else:
                x += 1
    mem.sort(key=lambda m: (m[3], m[4]))
    return mem


def brute_smems(idx: FMIndex, q: np.ndarray):
    """Brute-force SMEMs by definition (tests only): strictly-increasing
    records of E(s) = longest exact match starting at s."""
    S = idx.seq
    L = len(q)
    E = np.zeros(L, dtype=np.int64)
    text = S.tobytes()
    for s in range(L):
        if q[s] > 3:
            E[s] = s
            continue
        lo, hi = s + 1, L
        # extend greedily: find max e such that q[s:e] occurs in S
        e = s
        while e < L and q[e] <= 3:
            if text.find(q[s:e + 1].tobytes()) < 0:
                break
            e += 1
        E[s] = e
    out = []
    best = -1
    for s in range(L):
        if E[s] > s and E[s] > best:
            out.append((s, int(E[s])))
            best = E[s]
    return out


# =====================================================================
# Batched lockstep implementation (the paper's reorganization)
# =====================================================================

@dataclasses.dataclass
class SmemTaskBatch:
    """Output of a batch of smem1 tasks, ragged: one flat (M,) int64 array
    a field, the SMEMs task by task in task order, each task's sorted by
    start coordinate."""
    task: np.ndarray   # the task of each SMEM
    k: np.ndarray
    l: np.ndarray
    s: np.ndarray
    qbeg: np.ndarray
    qend: np.ndarray
    n: np.ndarray      # (T,) number of SMEMs per task
    ret: np.ndarray    # (T,) next x


_NEVER = np.iinfo(np.int64).max


def _ext_round(idx: FMIndex, which: str, host: np.ndarray, occ: OccConfig):
    """One extension round through the round kernel ``occ`` names, on
    its device.

    ``host`` is a C-contiguous int32 (4, n) array, the rows k, l, s, c of
    the round's entries, which the caller builds from its flat state (the
    ``smem.pack`` span) and writes no more: it goes to the device as ONE
    tensor, ``ext_round`` extends it there, and (k', l', s') come back as
    one int32 (3, n) array.

    Span ``smem.round`` (the copy in, the launch and the readback that
    waits for it); counters ``smem_live_entries`` (n) and
    ``smem_round_slots`` (the rows of host state the round's work runs
    over: n, as the state holds the live entries alone)."""
    obs.count("smem_rounds")
    n = host.shape[1]
    obs.count("smem_live_entries", n)
    obs.count("smem_round_slots", n)
    if not n:
        return np.empty((3, 0), np.int32)
    dev = occ.device
    with obs.span("smem.round"):
        st = torch.from_numpy(host).to(dev)
        got = ext_round(idx.device(dev), which, *st, layout=occ.layout,
                        block=occ.block).cpu().numpy()
    obs.count("smem_h2d_bytes", host.nbytes)
    obs.count("smem_d2h_bytes", got.nbytes)
    return got


def _pack(kls: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The (4, n) int32 host buffer of a round: rows k, l, s, then c."""
    with obs.span("smem.pack"):
        host = np.empty((4, len(c)), np.int32)
        host[:3] = kls
        host[3] = c
    return host


def _first_intervals(idx: FMIndex, b: np.ndarray):
    """(k, l, s) of the single-base strings ``b`` (codes 0..3)."""
    C = np.asarray(idx.C, np.int64)
    cnt4 = np.array([idx.init_interval(c)[2] for c in range(4)], np.int64)
    return C[b], C[3 - b], cnt4[b]


def _segments_reversed(recs: np.ndarray) -> np.ndarray:
    """``recs`` (rows: task, ...) appended in time order, regrouped task
    by task in task order with each task's records newest first."""
    recs = recs[:, ::-1]
    return recs.take(np.argsort(recs[0], kind="stable"), axis=1)


def smem1_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                task_read: np.ndarray, task_x: np.ndarray,
                task_min_intv: np.ndarray, *,
                occ: OccConfig) -> SmemTaskBatch:
    """Lockstep-batched smem1 over T independent tasks.

    Per round, ONE vectorized extension call serves every live (task, entry)
    pair — the device analogue of the paper's software-prefetch batching.
    The state is compact: flat arrays of the live entries in task order
    (each task's in list order), and of the live tasks, so a round's host
    work follows its live entries.  Tasks that die drop out.  Output is
    bit-identical to calling ``smem1`` per task.
    """
    T = len(task_read)
    L = int(reads.shape[1])
    qf = np.ascontiguousarray(reads).reshape(-1)
    rd = np.asarray(task_read, np.int64)
    x = np.asarray(task_x, np.int64)
    lens_t = np.asarray(lens, np.int64)[rd]
    min_intv = np.maximum(np.asarray(task_min_intv, np.int64), 1)
    b0 = qf[rd * L + np.minimum(x, L - 1)]
    valid = np.flatnonzero((b0 <= 3) & (x < lens_t))
    xv = x[valid]

    # ---- forward phase: one column a live task ----
    # rows: task, k, l, s, x, x's offset in qf, lens - x, min_intv.  At
    # step ``step`` every live task's interval ends at x + step.
    F = np.stack([valid, *_first_intervals(idx, b0[valid].astype(np.int64)),
                  xv, rd[valid] * L + xv, lens_t[valid] - xv,
                  min_intv[valid]])
    pushes = [np.empty((5, 0), np.int64)]   # (task, k, l, s, end) in time order

    def push(mask):
        rec = F[:5].compress(mask, axis=1)
        rec[4] += step
        pushes.append(rec)

    # a task that dies in a round leaves F in the next step's one
    # compaction, with the tasks that end there
    dead = np.zeros(F.shape[1], bool)
    step = 1
    while True:
        go = (F[6] > step) & ~dead         # not at the read's end yet
        ended = ~(go | dead)
        if ended.any():
            push(ended)
        b = qf.take(F[5] + step, mode="clip")
        amb = go & (b > 3)                 # ambiguous base: stop fwd extension
        if amb.any():
            push(amb)
            go &= ~amb
        if not go.all():
            F = F.compress(go, axis=1); b = b.compress(go)
        if not F.shape[1]:
            break
        got = _ext_round(idx, "fwd", _pack(F[1:4], b), occ)
        changed = got[2] != F[3]           # interval size changed
        if changed.any():
            push(changed)
        dead = changed & (got[2] < F[7])
        with obs.span("smem.unpack"):
            F[1:4] = got
        step += 1

    # each task's list longest first: its pushes newest first
    recs = _segments_reversed(np.concatenate(pushes, axis=1))
    cnt = np.bincount(recs[0], minlength=T)[valid]   # >= 1: every run pushes
    ret = x + 1
    ret[valid] = recs[4].take(np.cumsum(cnt) - cnt)

    # ---- backward phase ----
    # rows: task, i, min_intv, qbeg of the task's last SMEM, read's offset;
    # a task's entries are the next cnt of kls and end
    B = np.stack([valid, xv - 1, min_intv[valid],
                  np.full(len(valid), _NEVER), rd[valid] * L])
    kls = recs[1:4]
    end = recs[4]
    mems = [np.empty((6, 0), np.int64)]   # (task, k, l, s, qbeg, qend)
    while len(cnt):
        i = B[1]
        c = qf.take(B[4] + i, mode="clip")
        c = np.where((i >= 0) & (c <= 3), c, 4)
        host = _pack(kls, np.repeat(c, cnt))
        got = _ext_round(idx, "bwd", host, occ)
        # the round's sweep, over its entries at once: an entry fails on
        # an ambiguous base, at the read's start or below min_intv; a
        # task emits its first entry when that fails (no longer match
        # survived) and is not contained in its last SMEM; a surviving
        # entry is kept unless its size equals the task's last survivor's
        with obs.span("smem.sweep"):
            ok = got[2] >= np.repeat(np.where(c <= 3, B[2], _NEVER), cnt)
            starts = np.cumsum(cnt) - cnt
            emit = ~ok.take(starts) & (i + 1 < B[3])
            if emit.any():
                m = np.flatnonzero(emit)
                st = starts.take(m)
                B[3, m] = i.take(m) + 1
                mems.append(np.vstack([B[0].take(m), host[:3].take(st, axis=1),
                                       B[3].take(m), end.take(st)]))
            kept = np.flatnonzero(ok)
            s_k = got[2].take(kept)
            seg = np.repeat(np.arange(len(cnt)), cnt).take(kept)
            new = np.ones(len(kept), bool)
            new[1:] = (s_k[1:] != s_k[:-1]) | (seg[1:] != seg[:-1])
            kept = kept.compress(new)
            cnt = np.bincount(seg.compress(new), minlength=len(cnt))
        with obs.span("smem.unpack"):
            kls = got.take(kept, axis=1)
            end = end.take(kept)
        live = cnt > 0
        if not live.all():
            B = B.compress(live, axis=1); cnt = cnt.compress(live)
        B[1] -= 1

    # each task's SMEMs sorted by start coordinate: newest first
    out = _segments_reversed(np.concatenate(mems, axis=1))
    return SmemTaskBatch(*out, n=np.bincount(out[0], minlength=T), ret=ret)


def seed_strategy1_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                         task_read: np.ndarray, task_x: np.ndarray,
                         min_len: int, max_intv: int, *,
                         occ: OccConfig):
    """Lockstep-batched bwt_seed_strategy1 over compact state (the live
    tasks alone). Returns (out (T, 5) k,l,s,qb,qe; has; ret)."""
    T = len(task_read)
    L = int(reads.shape[1])
    qf = np.ascontiguousarray(reads).reshape(-1)
    rd = np.asarray(task_read, np.int64)
    x = np.asarray(task_x, np.int64)
    lens_t = np.asarray(lens, np.int64)[rd]
    b0 = qf[rd * L + np.minimum(x, L - 1)]
    valid0 = (b0 <= 3) & (x < lens_t)
    valid = np.flatnonzero(valid0)
    xv = x[valid]

    out = np.zeros((T, 5), np.int64)
    has = np.zeros(T, bool)
    ret = np.where(valid0, lens_t, x + 1)
    # rows: task, k, l, s, x's offset in qf, lens - x
    F = np.stack([valid, *_first_intervals(idx, b0[valid].astype(np.int64)),
                  rd[valid] * L + xv, lens_t[valid] - xv])
    # a task that hits in a round leaves F at the next step's compaction
    hit = np.zeros(F.shape[1], bool)
    step = 1
    while True:
        go = (F[5] > step) & ~hit          # the rest keep ret = lens
        b = qf.take(F[4] + step, mode="clip")
        amb = go & (b > 3)
        if amb.any():
            t = F[0, amb]
            ret[t] = x[t] + step + 1
            go &= ~amb
        if not go.all():
            F = F.compress(go, axis=1); b = b.compress(go)
        if not F.shape[1]:
            break
        got = _ext_round(idx, "fwd", _pack(F[1:4], b), occ)
        hit = (got[2] < max_intv) & (step >= min_len)
        if hit.any():
            t = F[0, hit]
            ret[t] = x[t] + step + 1
            good = hit & (got[2] > 0)
            g = F[0, good]
            out[g, :3] = got[:, good].T
            out[g, 3] = x[g]; out[g, 4] = x[g] + step + 1
            has[g] = True
        with obs.span("smem.unpack"):
            F[1:4] = got
        step += 1
    return out, has, ret


def _long_mems(batch: SmemTaskBatch, task_read: np.ndarray, min_len: int):
    """(read, k, l, s, qbeg, qend) rows of the batch's SMEMs at least
    ``min_len`` long, in the batch's order."""
    keep = batch.qend - batch.qbeg >= min_len
    return np.stack([task_read[batch.task], batch.k, batch.l, batch.s,
                     batch.qbeg, batch.qend])[:, keep]


def collect_smems_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                        opt: MemOptions, *, occ: OccConfig):
    """Batched mem_collect_intv over a whole read batch (the Fig-2 workflow).

    Returns per-read python lists of (k,l,s,qb,qe), identical to
    ``collect_smems`` per read.
    """
    R, L = reads.shape
    lens = np.asarray(lens, np.int64)
    # (read, k, l, s, qbeg, qend) blocks, each read's rows in the order
    # mem_collect_intv appends them
    found = [np.empty((6, 0), np.int64)]
    rows = np.arange(R)

    # ---- pass 1: x-loop in lockstep rounds over reads ----
    x = np.zeros(R, np.int64)
    # skip leading ambiguous bases without an smem1 call (bwa's else ++x)
    while True:
        active = x < lens
        if not active.any():
            break
        cur_b = reads[rows, np.minimum(x, L - 1)]
        amb = active & (cur_b > 3)
        x[amb] += 1
        run = active & ~amb
        if not run.any():
            continue
        tr = np.flatnonzero(run)
        batch = smem1_batch(idx, reads, lens, tr, x[tr],
                            np.ones(len(tr), np.int64), occ=occ)
        found.append(_long_mems(batch, tr, opt.min_seed_len))
        x[tr] = batch.ret

    # ---- pass 2: re-seeding, all tasks known upfront -> one batch ----
    # every pass-1 SMEM, read by read in the order found
    p1 = np.concatenate(found, axis=1)
    p1 = p1[:, np.argsort(p1[0], kind="stable")]
    split = p1[:, (p1[5] - p1[4] >= opt.split_len) & (p1[3] <= opt.split_width)]
    if split.shape[1]:
        batch = smem1_batch(idx, reads, lens, split[0],
                            (split[4] + split[5]) >> 1, split[3] + 1,
                            occ=occ)
        found.append(_long_mems(batch, split[0], opt.min_seed_len))

    # ---- pass 3: forward-only seeds, lockstep x-loop ----
    if opt.max_mem_intv > 0:
        x = np.zeros(R, np.int64)
        while True:
            active = x < lens
            if not active.any():
                break
            cur_b = reads[rows, np.minimum(x, L - 1)]
            amb = active & (cur_b > 3)
            x[amb] += 1
            run = active & ~amb
            if not run.any():
                continue
            tr = np.flatnonzero(run)
            out, has, ret = seed_strategy1_batch(
                idx, reads, lens, tr, x[tr], opt.min_seed_len,
                opt.max_mem_intv, occ=occ)
            found.append(np.vstack([tr[has], out[has].T]))
            x[tr] = ret

    # each read's SMEMs by (qbeg, qend), ties in the order found (a
    # stable sort, as Python's)
    m = np.concatenate(found, axis=1)
    m = m[:, np.lexsort((m[5], m[4], m[0]))]
    tuples = list(zip(*(row.tolist() for row in m[1:])))
    ends = np.cumsum(np.bincount(m[0], minlength=R)).tolist()
    return [tuples[a:b] for a, b in zip([0] + ends[:-1], ends)]
