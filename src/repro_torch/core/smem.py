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
  The task state stays on the host in numpy int64.  Each round sends
  only its live entries — the ones whose results the loop reads — to the
  index's device as one (4, n) int32 (k, l, s, c) tensor, runs the whole
  extension there (``kernels.fmocc.ext_round``: one launch of the fused
  round kernel, every occ lookup inside it) and brings (3, n) (k', l', s')
  back in one copy — one device round trip per round.

An SMEM is reported as (k, l, s, qbeg, qend): bi-interval + query span.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import obs
from ..kernels.fmocc.ops import ext_round
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
    """Output of a batch of smem1 tasks (padded)."""
    k: np.ndarray      # (T, M) int32
    l: np.ndarray
    s: np.ndarray
    qbeg: np.ndarray
    qend: np.ndarray
    n: np.ndarray      # (T,) number of SMEMs per task
    ret: np.ndarray    # (T,) next x


def _ext_round(idx: FMIndex, which: str, k, l, s, c, occ_fn, live):
    """One extension round on ``occ_fn``'s device, of the entries in
    ``live``.

    ``occ_fn`` is a configuration callable carrying ``.layout``,
    ``.block`` and ``.device`` (``kernels.fmocc.make_occ_fn``).  k, l, s
    and c broadcast to ``live``'s shape; the entries where ``live`` holds
    go to the device as ONE int32 (4, n) tensor, ``ext_round`` extends
    them there, and (k', l', s') come back as one (3, n) copy, scattered
    into int64 arrays of ``live``'s shape.  The other positions hold 0:
    the callers read no result outside ``live``."""
    obs.count("smem_rounds")
    out = np.zeros((3, *live.shape), np.int64)
    sel = np.nonzero(live)
    n = len(sel[0])
    if n:
        host = np.empty((4, n), np.int32)
        for row, a in zip(host, (k, l, s, c)):
            row[:] = np.broadcast_to(a, live.shape)[sel]
        dev = occ_fn.device
        st = torch.from_numpy(host).to(dev)
        got = ext_round(idx.device(dev), which, *st, layout=occ_fn.layout,
                        block=occ_fn.block).cpu().numpy()
        obs.count("smem_h2d_bytes", host.nbytes)
        obs.count("smem_d2h_bytes", got.nbytes)
        out[(slice(None), *sel)] = got
    return out[0], out[1], out[2]


def smem1_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                task_read: np.ndarray, task_x: np.ndarray,
                task_min_intv: np.ndarray, *,
                occ_fn: Callable,
                cap: int | None = None) -> SmemTaskBatch:
    """Lockstep-batched smem1 over T independent tasks.

    Per round, ONE vectorized extension call serves every live (task, entry)
    pair — the device analogue of the paper's software-prefetch batching.
    Output is bit-identical to calling ``repro.core.smem.smem1`` per task.
    """
    T = len(task_read)
    L = int(reads.shape[1])
    P = cap or (L + 1)
    q = reads[task_read]                       # (T, L) uint8
    lens_t = lens[task_read].astype(np.int64)
    x = task_x.astype(np.int64)
    min_intv = np.maximum(task_min_intv.astype(np.int64), 1)

    b0 = q[np.arange(T), np.minimum(x, L - 1)].astype(np.int64)
    valid0 = (b0 <= 3) & (x < lens_t)
    C = np.asarray(idx.C)
    cnt4 = np.array([idx.init_interval(c)[2] for c in range(4)], dtype=np.int64)
    b0c = np.clip(b0, 0, 3)
    ik_k = np.where(valid0, C[b0c], 0)
    ik_l = np.where(valid0, C[3 - b0c], 0)
    ik_s = np.where(valid0, cnt4[b0c], 0)
    ik_end = x + 1

    # ---- forward phase ----
    curr_k = np.zeros((T, P), np.int64); curr_l = np.zeros((T, P), np.int64)
    curr_s = np.zeros((T, P), np.int64); curr_e = np.zeros((T, P), np.int64)
    curr_n = np.zeros(T, np.int64)
    alive = valid0.copy()

    def push(mask, kk, ll, ss, ee):
        idxs = np.nonzero(mask)[0]
        slot = curr_n[idxs]
        assert (slot < P).all(), "SMEM forward cap overflow"
        curr_k[idxs, slot] = kk[idxs]; curr_l[idxs, slot] = ll[idxs]
        curr_s[idxs, slot] = ss[idxs]; curr_e[idxs, slot] = ee[idxs]
        curr_n[idxs] += 1

    step = 1
    while alive.any():
        i = x + step
        in_range = alive & (i < lens_t)
        # tasks whose forward run ends exactly at the read end
        ended = alive & ~in_range
        push(ended, ik_k, ik_l, ik_s, ik_end)
        alive = in_range
        if not alive.any():
            break
        b = q[np.arange(T), np.minimum(i, L - 1)].astype(np.int64)
        amb = alive & (b > 3)
        push(amb, ik_k, ik_l, ik_s, ik_end)
        alive = alive & ~amb
        if not alive.any():
            break
        ok_k, ok_l, ok_s = _ext_round(idx, "fwd", ik_k, ik_l, ik_s,
                                      np.clip(b, 0, 4), occ_fn, alive)
        changed = alive & (ok_s != ik_s)
        push(changed, ik_k, ik_l, ik_s, ik_end)
        dead = changed & (ok_s < min_intv)
        alive = alive & ~dead
        upd = alive
        ik_k = np.where(upd, ok_k, ik_k); ik_l = np.where(upd, ok_l, ik_l)
        ik_s = np.where(upd, ok_s, ik_s); ik_end = np.where(upd, i + 1, ik_end)
        step += 1

    # reverse each task's curr list -> longest-first
    for t in np.nonzero(valid0)[0]:
        n = curr_n[t]
        curr_k[t, :n] = curr_k[t, :n][::-1]; curr_l[t, :n] = curr_l[t, :n][::-1]
        curr_s[t, :n] = curr_s[t, :n][::-1]; curr_e[t, :n] = curr_e[t, :n][::-1]
    ret = np.where(valid0, np.where(curr_n > 0, curr_e[:, 0], x + 1), x + 1)

    # ---- backward phase ----
    prev_k, prev_l, prev_s, prev_e = curr_k, curr_l, curr_s, curr_e
    prev_n = curr_n.copy()
    M = P
    mem_k = np.zeros((T, M), np.int64); mem_l = np.zeros((T, M), np.int64)
    mem_s = np.zeros((T, M), np.int64); mem_qb = np.zeros((T, M), np.int64)
    mem_qe = np.zeros((T, M), np.int64); mem_n = np.zeros(T, np.int64)
    active = valid0 & (prev_n > 0)
    i_t = x - 1                               # per-task backward position

    while active.any():
        c = np.full(T, -1, np.int64)
        pos_ok = active & (i_t >= 0)
        bi = q[np.arange(T), np.maximum(np.minimum(i_t, L - 1), 0)].astype(np.int64)
        c = np.where(pos_ok & (bi <= 3), bi, -1)
        # one vectorized backward extension for ALL live entries
        ok_k, ok_l, ok_s = _ext_round(
            idx, "bwd", prev_k, prev_l, prev_s, np.where(c >= 0, c, 4)[:, None],
            occ_fn, active[:, None] & (np.arange(P) < prev_n[:, None]))
        # per-slot sweep, vectorized ACROSS tasks (the entry-list order
        # semantics only reference per-task running state: the count of
        # kept entries and the last kept size)
        pmax = int(prev_n[active].max()) if active.any() else 0
        n_new = np.zeros(T, np.int64)
        last_s = np.full(T, -1, np.int64)
        for j in range(pmax):
            live = active & (j < prev_n)
            fails = live & ((c < 0) | (ok_s[:, j] < min_intv))
            # emission: first failing entry this round, not contained
            emit = fails & (n_new == 0) & (
                (mem_n == 0) |
                (i_t + 1 < mem_qb[np.arange(T), np.maximum(mem_n - 1, 0)]))
            eidx = np.nonzero(emit)[0]
            if eidx.size:
                m = mem_n[eidx]
                assert (m < M).all(), "SMEM mem cap overflow"
                mem_k[eidx, m] = prev_k[eidx, j]
                mem_l[eidx, m] = prev_l[eidx, j]
                mem_s[eidx, m] = prev_s[eidx, j]
                mem_qb[eidx, m] = i_t[eidx] + 1
                mem_qe[eidx, m] = prev_e[eidx, j]
                mem_n[eidx] += 1
            keep = live & ~fails & ((n_new == 0) | (ok_s[:, j] != last_s))
            kidx = np.nonzero(keep)[0]
            if kidx.size:
                slot = n_new[kidx]
                curr_k[kidx, slot] = ok_k[kidx, j]
                curr_l[kidx, slot] = ok_l[kidx, j]
                curr_s[kidx, slot] = ok_s[kidx, j]
                curr_e[kidx, slot] = prev_e[kidx, j]
                n_new[kidx] += 1
                last_s[kidx] = ok_s[kidx, j]
        prev_n = np.where(active, n_new, prev_n)
        active = active & (n_new > 0)
        prev_k, curr_k = curr_k, prev_k
        prev_l, curr_l = curr_l, prev_l
        prev_s, curr_s = curr_s, prev_s
        prev_e, curr_e = curr_e, prev_e
        active = active & (i_t >= 0)
        i_t = i_t - 1

    # reverse mems -> sorted by start coordinate
    for t in range(T):
        n = mem_n[t]
        if n:
            mem_k[t, :n] = mem_k[t, :n][::-1]; mem_l[t, :n] = mem_l[t, :n][::-1]
            mem_s[t, :n] = mem_s[t, :n][::-1]
            mem_qb[t, :n] = mem_qb[t, :n][::-1]; mem_qe[t, :n] = mem_qe[t, :n][::-1]
    return SmemTaskBatch(mem_k, mem_l, mem_s, mem_qb, mem_qe, mem_n, ret)


def seed_strategy1_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                         task_read: np.ndarray, task_x: np.ndarray,
                         min_len: int, max_intv: int, *,
                         occ_fn: Callable):
    """Lockstep-batched bwt_seed_strategy1. Returns (mem or None per task, ret)."""
    T = len(task_read)
    L = int(reads.shape[1])
    q = reads[task_read]
    lens_t = lens[task_read].astype(np.int64)
    x = task_x.astype(np.int64)

    b0 = q[np.arange(T), np.minimum(x, L - 1)].astype(np.int64)
    valid0 = (b0 <= 3) & (x < lens_t)
    C = np.asarray(idx.C)
    cnt4 = np.array([idx.init_interval(c)[2] for c in range(4)], dtype=np.int64)
    b0c = np.clip(b0, 0, 3)
    ik_k = np.where(valid0, C[b0c], 0)
    ik_l = np.where(valid0, C[3 - b0c], 0)
    ik_s = np.where(valid0, cnt4[b0c], 0)

    out = np.zeros((T, 5), np.int64)   # k,l,s,qb,qe
    has = np.zeros(T, bool)
    ret = np.where(valid0, lens_t, x + 1)
    alive = valid0.copy()
    step = 1
    while alive.any():
        i = x + step
        in_range = alive & (i < lens_t)
        alive = in_range
        if not alive.any():
            break
        b = q[np.arange(T), np.minimum(i, L - 1)].astype(np.int64)
        amb = alive & (b > 3)
        ret = np.where(amb, i + 1, ret)
        alive = alive & ~amb
        if not alive.any():
            break
        ok_k, ok_l, ok_s = _ext_round(idx, "fwd", ik_k, ik_l, ik_s,
                                      np.clip(b, 0, 4), occ_fn, alive)
        hit = alive & (ok_s < max_intv) & ((i - x) >= min_len)
        good = hit & (ok_s > 0)
        out[good, 0] = ok_k[good]; out[good, 1] = ok_l[good]
        out[good, 2] = ok_s[good]; out[good, 3] = x[good]
        out[good, 4] = i[good] + 1
        has |= good
        ret = np.where(hit, i + 1, ret)
        alive = alive & ~hit
        upd = alive
        ik_k = np.where(upd, ok_k, ik_k); ik_l = np.where(upd, ok_l, ik_l)
        ik_s = np.where(upd, ok_s, ik_s)
        step += 1
    return out, has, ret


def collect_smems_batch(idx: FMIndex, reads: np.ndarray, lens: np.ndarray,
                        opt: MemOptions, *, occ_fn: Callable):
    """Batched mem_collect_intv over a whole read batch (the Fig-2 workflow).

    Returns per-read python lists of (k,l,s,qb,qe), identical to
    ``collect_smems`` per read.
    """
    R, L = reads.shape
    lens = np.asarray(lens, np.int64)
    mems: list[list[tuple[int, int, int, int, int]]] = [[] for _ in range(R)]

    # ---- pass 1: x-loop in lockstep rounds over reads ----
    x = np.zeros(R, np.int64)
    # skip leading ambiguous bases without an smem1 call (bwa's else ++x)
    while True:
        active = x < lens
        if not active.any():
            break
        cur_b = reads[np.arange(R), np.minimum(x, L - 1)]
        amb = active & (cur_b > 3)
        x[amb] += 1
        run = active & ~amb
        if not run.any():
            continue
        tr = np.nonzero(run)[0]
        batch = smem1_batch(idx, reads, lens, tr, x[tr],
                            np.ones(len(tr), np.int64), occ_fn=occ_fn)
        for ti, r in enumerate(tr):
            for m in range(batch.n[ti]):
                if batch.qend[ti, m] - batch.qbeg[ti, m] >= opt.min_seed_len:
                    mems[r].append((int(batch.k[ti, m]), int(batch.l[ti, m]),
                                    int(batch.s[ti, m]), int(batch.qbeg[ti, m]),
                                    int(batch.qend[ti, m])))
        x[tr] = batch.ret

    # ---- pass 2: re-seeding, all tasks known upfront -> one batch ----
    t_read, t_x, t_mi = [], [], []
    for r in range(R):
        for (k, l, s, qb, qe) in list(mems[r]):
            if qe - qb < opt.split_len or s > opt.split_width:
                continue
            t_read.append(r); t_x.append((qb + qe) >> 1); t_mi.append(s + 1)
    if t_read:
        batch = smem1_batch(idx, reads, lens, np.array(t_read),
                            np.array(t_x), np.array(t_mi), occ_fn=occ_fn)
        for ti, r in enumerate(t_read):
            for m in range(batch.n[ti]):
                if batch.qend[ti, m] - batch.qbeg[ti, m] >= opt.min_seed_len:
                    mems[r].append((int(batch.k[ti, m]), int(batch.l[ti, m]),
                                    int(batch.s[ti, m]), int(batch.qbeg[ti, m]),
                                    int(batch.qend[ti, m])))

    # ---- pass 3: forward-only seeds, lockstep x-loop ----
    if opt.max_mem_intv > 0:
        x = np.zeros(R, np.int64)
        while True:
            active = x < lens
            if not active.any():
                break
            cur_b = reads[np.arange(R), np.minimum(x, L - 1)]
            amb = active & (cur_b > 3)
            x[amb] += 1
            run = active & ~amb
            if not run.any():
                continue
            tr = np.nonzero(run)[0]
            out, has, ret = seed_strategy1_batch(
                idx, reads, lens, tr, x[tr], opt.min_seed_len,
                opt.max_mem_intv, occ_fn=occ_fn)
            for ti, r in enumerate(tr):
                if has[ti]:
                    mems[r].append(tuple(int(v) for v in out[ti]))
            x[tr] = ret

    for r in range(R):
        mems[r].sort(key=lambda m: (m[3], m[4]))
    return mems
