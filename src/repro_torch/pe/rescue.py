"""Mate rescue (mem_matesw port): the scalar baseline and the batched
driver, each whole in one function (``rescue_scalar``, ``rescue_batched``:
plan, extend and merge).

When one mate is unmapped (or has no alignment consistent with the
estimated insert-size distribution), bwa scans the window implied by its
partner's position and the per-orientation insert bounds and runs SW
against the reference there.  ``run_rescues_scalar`` (the ``baseline``
engine's) runs each extension inline through the scalar oracle, task by
task, as the original does.  ``run_rescues_batched`` organises it as
the paper's inter-task scheme (§5.3.1): every left/right extension of
every rescue task across the WHOLE batch is collected, length-sorted and
dispatched through the pipeline's ``BatchedBSWExecutor`` (so through the
bsw kernel on the pipeline's device), then the per-task decision logic
is replayed from the result table.  ``rescue_batched`` also scans every
window in one ``kernels.diagseed`` call and finalizes the accepted mates
in one ``kernels.galign`` call, both on ``opt.device``.

Task construction is shared with the reference: the mate read (as-is,
never re-complemented — the doubled reference's reverse half covers the
opposite strand) is anchored by its longest exact diagonal match inside
the rescue window, and the anchor seed is extended left/right exactly
like a one-seed chain through ``chain2aln``, so rescue output obeys the
same extension spec as the main pipeline.

A copy of ``repro.pe.rescue``, with ``plan_rescues`` in three passes
(the candidate windows, one anchor-seed search over all of them, the
tasks), so that the batched path scans a batch's windows in one
``diagseed`` launch; the tasks are the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .. import obs
from ..core.bsw import BSWParams
from ..core.chain import Chain
from ..core.contig import block_bounds, same_contig
from ..core.pipeline import (BatchedBSWExecutor, align_regions, apply_cigar,
                             approx_mapq, bsw_immediate, chain2aln,
                             host_align)
from ..kernels import diagseed as kdiagseed
from ..kernels import galign as kgalign
from .pestat import PairStat, infer_dir


@dataclasses.dataclass
class RescueTask:
    pair_id: int
    end: int                  # which end is being rescued (0 or 1)
    r: int                    # orientation being attempted
    chain: Chain              # single anchor seed inside the window
    query: np.ndarray         # the mate read, as-is


def best_diag_seed(q: np.ndarray, S: np.ndarray, wlo: int, whi: int,
                   min_len: int):
    """Longest exact diagonal match of ``q`` starting inside S[wlo:whi).

    Vectorized run-length scan over all diagonals: returns (rb, qb, len)
    in reference coordinates, or None when no run reaches ``min_len``.
    Ambiguous bases (>=4) never match.  Ties break toward the smallest
    diagonal, then the leftmost run (deterministic for both drivers).
    """
    L = len(q)
    n = whi - wlo
    if n < min_len or L < min_len:
        return None
    W = np.full(n + L, 5, np.uint8)
    W[:n] = S[wlo:whi]
    diag = np.lib.stride_tricks.sliding_window_view(W, L)[:n]   # (n, L)
    eq = (diag == q[None, :]) & (q[None, :] < 4)
    jj = np.arange(L)
    last_miss = np.maximum.accumulate(np.where(~eq, jj, -1), axis=1)
    runlen = np.where(eq, jj - last_miss, 0)                    # (n, L)
    best = int(runlen.max())
    if best < min_len:
        return None
    d, j_end = np.unravel_index(int(runlen.argmax()), runlen.shape)
    qb = int(j_end) - best + 1
    return (wlo + int(d) + qb, qb, best)


def rescue_window(idx, b1: int, r: int, pes_r: PairStat,
                  l_ms: int) -> tuple[int, int] | None:
    """Reference window [wlo, whi) that may contain the mate's start rb.

    Solves ``infer_dir(l_pac, b1, rb) == (r, dist)`` for ``dist`` in
    [low, high], widened by the mate length, then clamped to the anchor
    contig's block on the mate's strand (rescue never crosses a contig or
    the forward/reverse boundary, like _chain_rmax): a proper pair lives
    on ONE contig, so the mate is searched only inside the anchor's
    contig, mirrored to the other strand half for FR/RF orientations.
    """
    l_pac = idx.n_ref
    low, high = pes_r.low, pes_r.high
    if r == 0:                       # same strand, mate downstream
        lo, hi = b1 + low, b1 + high
    elif r == 3:                     # same strand, mate upstream
        lo, hi = b1 - high, b1 - low
    elif r == 1:                     # opposite strand, mate downstream
        lo, hi = 2 * l_pac - 1 - (b1 + high), 2 * l_pac - 1 - (b1 + low)
    else:                            # r == 2: opposite strand, upstream
        lo, hi = 2 * l_pac - 1 - b1 + low, 2 * l_pac - 1 - b1 + high
    wlo, whi = lo - l_ms, hi + l_ms
    same = r in (0, 3)
    alo, ahi = block_bounds(idx, b1)      # anchor contig, anchor strand
    blk_lo, blk_hi = (alo, ahi) if same \
        else (2 * l_pac - ahi, 2 * l_pac - alo)   # mirrored block
    wlo, whi = max(wlo, blk_lo), min(whi, blk_hi)
    if whi <= wlo:
        return None
    return int(wlo), int(whi)


@dataclasses.dataclass(frozen=True)
class PEOptions:
    """Paired-end knobs (bwa-mem defaults where they exist)."""
    max_ins: int = 10000
    pen_unpaired: int = 17
    max_matesw: int = 2              # rescue anchors per end (bwa: 50)
    rescue_min_seed: int = 10        # window anchor seed (< SMEM's 19)
    min_score: int = 30              # emission threshold (bwa -T)
    mapq_blend: bool = True          # bwa's q_pe/q_se pair-aware MAPQ
    # Pre-computed PairStat[4] (e.g. a memdist bootstrap estimate); when
    # set, pair_pipeline skips per-batch estimation so output doesn't
    # depend on which batch/shard saw which pairs.
    frozen_pes: tuple | None = None


def host_diag_seeds(queries, S: np.ndarray, wlos, whis,
                    min_len: int) -> np.ndarray:
    """``best_diag_seed`` candidate by candidate on the host, the original
    organisation: (C, 3) int64 rows (d, j_end, len), len 0 where no run
    reaches ``min_len``."""
    out = np.zeros((len(queries), 3), np.int64)
    for k, (q, wlo, whi) in enumerate(zip(queries, wlos, whis)):
        seed = best_diag_seed(q, S, wlo, whi, min_len)
        if seed is not None:
            rb, qb, ln = seed
            out[k] = (rb - wlo - qb, qb + ln - 1, ln)
    return out


def plan_rescues(results: tuple, reads: tuple, pes: list[PairStat],
                 idx, peopt: PEOptions, *,
                 seed_fn=host_diag_seeds) -> list[RescueTask]:
    """mem_sam_pe's rescue fan-out, planned from the PRE-rescue state.

    For each end's strong alignments (score within pen_unpaired of the
    best, capped at max_matesw), attempt every non-failed orientation for
    which the OTHER end has no consistent alignment yet.  Planning from a
    snapshot (unlike bwa's accumulate-as-you-go) makes the task list — and
    therefore the output — independent of execution order, which is what
    lets the scalar and batched drivers be byte-identical.

    Three passes: the candidate windows of every pair, end, anchor and
    orientation; one ``seed_fn(queries, S, wlos, whis, min_len)`` call for
    all of them, (C, 3) rows (d, j_end, len) of each window's anchor seed
    (``host_diag_seeds``, window by window on the host, or
    ``kernels.diagseed.diag_seed_batch`` on a device); the tasks, in
    candidate order.
    """
    S, l_pac = idx.seq, idx.n_ref
    cands: list[tuple] = []      # (pid, other end, r, wlo, whi)
    queries: list[np.ndarray] = []
    n_pairs = len(results[0])
    for pid in range(n_pairs):
        regs = (results[0][pid], results[1][pid])
        for i in (0, 1):
            if not regs[i]:
                continue
            other = 1 - i
            best = regs[i][0].score
            anchors = [a for a in regs[i]
                       if a.secondary < 0
                       and a.score >= best - peopt.pen_unpaired]
            anchors = anchors[:peopt.max_matesw]
            mate = reads[other][pid]
            for a in anchors:
                # orientations already satisfied by a mate alignment
                # consistent with THIS anchor (mem_matesw's skip[], which
                # re-evaluates per call); an alignment on a different
                # contig can never be consistent with the anchor
                skip = [pes[r].failed for r in range(4)]
                for m in regs[other]:
                    if not same_contig(idx, a.rb, m.rb):
                        continue
                    r, d = infer_dir(l_pac, a.rb, m.rb)
                    if not pes[r].failed and pes[r].low <= d <= pes[r].high:
                        skip[r] = True
                for r in range(4):
                    if skip[r]:
                        continue
                    win = rescue_window(idx, a.rb, r, pes[r], len(mate))
                    if win is None:
                        continue
                    cands.append((pid, other, r, win[0], win[1]))
                    queries.append(mate)
    obs.count("rescue_windows", len(cands))
    min_len = peopt.rescue_min_seed
    seeds = np.asarray(seed_fn(queries, S, [c[3] for c in cands],
                               [c[4] for c in cands], min_len))
    tasks: list[RescueTask] = []
    for (pid, other, r, wlo, whi), mate, (d, j_end, ln) in zip(
            cands, queries, seeds.tolist()):
        if ln < min_len:
            continue
        qb = j_end - ln + 1
        obs.observe("rescue_window_bp", whi - wlo)
        tasks.append(RescueTask(pair_id=pid, end=other, r=r,
                                chain=Chain(seeds=[(wlo + d + qb, qb, ln)]),
                                query=mate))
    obs.count("rescue_planned", len(tasks))
    return tasks


def run_rescues_scalar(tasks: list[RescueTask], idx, p: BSWParams):
    """Baseline: each rescue extension runs the scalar oracle inline."""
    fn = bsw_immediate(p)
    n_ext = [0]

    def counting(side, seed_id, rnd, q, t, h0, w):
        # count only real extensions, matching the batched executor's
        # stats (empty-sequence tasks short-circuit in both drivers)
        if len(q) > 0 and len(t) > 0:
            n_ext[0] += 1
        return fn(side, seed_id, rnd, q, t, h0, w)

    outs = [chain2aln(t.chain, t.query, idx, p, counting)
            for t in tasks]
    return outs, dict(rescue_tasks=len(tasks), rescue_bsw=n_ext[0])


def run_rescues_batched(tasks: list[RescueTask], idx, p: BSWParams, *,
                        device, sort: bool = True):
    """All rescue extensions across the batch pooled, length-sorted and
    dispatched through the batched BSW executor on ``device``, then
    decisions replayed per task — same structure as the main pipeline's
    Stage 4, through the same bsw kernel."""
    execu = BatchedBSWExecutor(p, device=device, sort=sort)
    execu.plan_and_run([(ti, t.chain, t.query, idx)
                        for ti, t in enumerate(tasks)])
    outs = [chain2aln(t.chain, t.query, idx, p, execu.executor(ti))
            for ti, t in enumerate(tasks)]
    return outs, dict(rescue_tasks=len(tasks),
                      rescue_bsw=execu.stats["tasks"],
                      rescue_cells_useful=execu.stats["cells_useful"],
                      rescue_cells_total=execu.stats["cells_total"])


def merge_rescues(results: tuple, tasks: list[RescueTask], outs: list,
                  idx, p: BSWParams,
                  min_seed_len: int, peopt: PEOptions, *,
                  align=host_align) -> int:
    """Fold rescue alignments into the per-end lists (task order is
    deterministic, so so is the merge).

    Keeps bwa's acceptance gates: score at least min_seed_len matches and
    the emission threshold; duplicate regions (two anchors rescuing the
    same placement) are dropped.  Returns the number of accepted rescues.

    The accepted mates are collected first and all of their CIGARs come
    from one call of ``align`` (``core.pipeline.host_align``, or
    ``kernels.galign.global_align_batch`` on a device): the dedup reads
    only ``rb`` and ``re``, which finalize does not change, so the mates
    accepted are those that finalizing each on acceptance accepts.
    """
    S, l_pac = idx.seq, idx.n_ref
    accepted = []
    for t, alns in zip(tasks, outs):
        for a in alns:
            if a.score < min_seed_len * p.a or a.truesc < peopt.min_score:
                continue
            regs = results[t.end][t.pair_id]
            # dedup on reference coords only: finalize flips qb/qe into
            # SAM read coords for reverse hits, so query coords are not
            # comparable between pre- and post-finalize records
            if any(x.rb == a.rb and x.re == a.re for x in regs):
                continue
            a.rescued = True
            regs.append(a)
            accepted.append((a, t.query))
    for (a, q), cig in zip(accepted, align_regions(accepted, S, p, align)):
        apply_cigar(a, q, S, l_pac, cig)
        a.mapq = approx_mapq(a, p, min_seed_len)
    return len(accepted)


def rescue_scalar(results: tuple, reads: tuple, pes: list[PairStat], idx,
                  opt, peopt: PEOptions):
    """Mate rescue as the original organisation runs it, on the host:
    each window scanned by ``best_diag_seed``, each extension by the
    scalar oracle, each accepted mate finalized by
    ``global_align_cigar``.  ``results`` are extended in place.  Returns
    (the number of accepted rescues, stats)."""
    with obs.span("pe_rescue.plan"):
        tasks = plan_rescues(results, reads, pes, idx, peopt)
    with obs.span("pe_rescue.extend"):
        outs, stats = run_rescues_scalar(tasks, idx, opt.bsw)
    with obs.span("pe_rescue.merge"):
        n = merge_rescues(results, tasks, outs, idx, opt.bsw,
                          opt.mem.min_seed_len, peopt)
    return n, stats


def rescue_batched(results: tuple, reads: tuple, pes: list[PairStat], idx,
                   opt, peopt: PEOptions):
    """``rescue_scalar``'s result, the batch's work pooled on
    ``opt.device``: every window in one ``diag_seed_batch`` call, the
    extensions through ``run_rescues_batched`` and the accepted mates in
    one ``global_align_batch`` call."""
    dev = opt.device
    with obs.span("pe_rescue.plan"):
        tasks = plan_rescues(results, reads, pes, idx, peopt,
                             seed_fn=functools.partial(
                                 kdiagseed.diag_seed_batch, device=dev))
    with obs.span("pe_rescue.extend"):
        outs, stats = run_rescues_batched(tasks, idx, opt.bsw, device=dev,
                                          sort=opt.bsw_sort)
    with obs.span("pe_rescue.merge"):
        n = merge_rescues(results, tasks, outs, idx, opt.bsw,
                          opt.mem.min_seed_len, peopt,
                          align=functools.partial(
                              kgalign.global_align_batch, device=dev))
    return n, stats
