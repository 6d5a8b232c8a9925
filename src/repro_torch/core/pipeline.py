"""BWA-MEM pipeline: SMEM -> SAL -> CHAIN -> BSW -> SAM-FORM.

The PyTorch counterpart of ``repro.core.pipeline``.  Two organisations
with IDENTICAL output, registered as the ``cuda`` and ``baseline``
engines of ``repro_torch.api``:

* ``run_se_batched`` — the paper's reorganisation (Fig 2 right; PE's
  ``repro_torch.pe.run_pe_batched`` runs both ends through it and then
  the paired-end tail): every stage runs over the WHOLE batch
  before the next stage; lockstep-batched SMEM whose occ lookups run on
  the device, a single-gather SAL on the device, and inter-task BSW with
  length-sorting (§5.3.1) through the bsw kernel.  Extension decisions
  that bwa makes sequentially (skip-if-contained; band-doubling retry)
  are replayed AFTER batched extension, exactly like bwa-mem2 (§5.3.2).
  The kernels are called on ``opt.device`` through their packages
  (``kernels.bsw``, ``kernels.galign``), looked up at each call; SMEM's
  round kernel is the ``OccConfig`` the caller passes.  PE mate rescue
  reuses ``BatchedBSWExecutor``, so its extensions go through the same
  kernel.

* ``run_se_baseline`` (and PE's ``repro_torch.pe.run_pe_baseline``) —
  the original BWA-MEM organisation (Fig 2 left), the yardstick of the
  paper's speedups:
  each read runs through every stage before the next read starts, with
  the scalar oracles on the host whatever ``device`` says (the SMEM
  oracle over ``FMIndex.occ``, one compressed-SA LF walk a lookup,
  ``bsw_extend`` inline, scalar mate rescue).  It launches no kernel.

The decision logic (``chain2aln``, the executor, ``mark_and_finalize``)
is the reference's own code, so the SAM is byte-identical to the
reference's ``baseline``, ``batched`` and ``pallas`` engines.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Callable

import numpy as np

from .. import obs
from ..kernels import bsw as kbsw
from ..kernels import galign as kgalign
from ..kernels.fmocc.ops import DEFAULT_CANDIDATE, OccConfig
from . import smem as smem_mod
from . import sal as sal_mod
from .bsw import BSWParams, ExtResult, bsw_extend, bsw_extend_tasks
from .chain import Chain, ChainOptions, chain_seeds, filter_chains
from .contig import block_bounds, contig_edges
from .fmindex import FMIndex
from .sam import global_align_cigar
from .smem import MemOptions

MAX_BAND_TRY = 2
MAPQ_COEF = 30.0


@dataclasses.dataclass
class Alignment:
    qb: int; qe: int; rb: int; re: int
    score: int; truesc: int; w: int
    seedcov: int; seedlen0: int
    sub: int = 0; csub: int = 0
    secondary: int = -1
    supplementary: bool = False   # non-first primary region (SAM 0x800)
    hard_clip: bool = False       # emit clips as H (supplementary w/o -Y)
    rescued: bool = False     # placed by PE mate rescue, not by seeding
    frac_rep: float = 0.0     # read's repeat fraction (bwa frac_rep; the
                              # PE MAPQ blend scales q_pe by it)
    # filled by finalize():
    pos: int = -1; is_rev: bool = False; mapq: int = 0
    cigar: list = dataclasses.field(default_factory=list)
    nm: int = 0


def cal_max_gap(p: BSWParams, qlen: int, w: int) -> int:
    l_del = int((qlen * p.a - p.o_del) / p.e_del + 1.0)
    l_ins = int((qlen * p.a - p.o_ins) / p.e_ins + 1.0)
    l = max(max(l_del, l_ins), 1)
    return min(l, w << 1)


def _chain_rmax(chain: Chain, l_query: int, idx: FMIndex, p: BSWParams,
                w: int) -> tuple[int, int]:
    """Reference window a chain's extensions may touch, clamped to the
    contig block of the chain's first seed (for one contig: the strand
    half, exactly bwa's fwd/rev-boundary clamp)."""
    l_pac = idx.n_ref
    r0, r1 = l_pac << 1, 0
    for (rb, qb, ln) in chain.seeds:
        b = rb - (qb + cal_max_gap(p, qb, w))
        e = rb + ln + ((l_query - qb - ln) + cal_max_gap(p, l_query - qb - ln, w))
        r0 = min(r0, b)
        r1 = max(r1, e)
    lo, hi = block_bounds(idx, chain.seeds[0][0])
    return max(r0, lo), min(r1, hi)


def _seed_order(chain: Chain) -> list[int]:
    """bwa srt order: by (score=len, index) ascending, visited from the end."""
    n = len(chain.seeds)
    order = sorted(range(n), key=lambda i: (chain.seeds[i][2], i))
    return order[::-1]


def chain2aln(chain: Chain, query: np.ndarray, idx: FMIndex,
              p: BSWParams, bsw_fn: Callable) -> list[Alignment]:
    """Port of mem_chain2aln.  ``bsw_fn(side, seed_id, rnd, q, t, h0, w)``
    returns an ExtResult; the executor argument is what lets the optimized
    pipeline substitute precomputed batched extensions."""
    S = idx.seq
    l_query = len(query)
    rmax0, rmax1 = _chain_rmax(chain, l_query, idx, p, p.w)
    rseq = S[rmax0:rmax1]
    out: list[Alignment] = []
    order = _seed_order(chain)
    alive = {k: True for k in order}
    for oi, k in enumerate(order):
        rb_s, qb_s, ln_s = chain.seeds[k]
        # --- containment test against existing alignments ---
        contained = False
        for a in out:
            if (rb_s < a.rb or rb_s + ln_s > a.re or
                    qb_s < a.qb or qb_s + ln_s > a.qe):
                continue
            if ln_s - a.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = qb_s - a.qb, rb_s - a.rb
            mg = cal_max_gap(p, min(qd, rd), p.w)
            w = min(mg, a.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
            qd, rd = a.qe - (qb_s + ln_s), a.re - (rb_s + ln_s)
            mg = cal_max_gap(p, min(qd, rd), p.w)
            w = min(mg, a.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
        if contained:
            # confirm no overlapping same-chain seed suggests a different aln
            confirm = True
            for oj in range(oi):
                j = order[oj]
                if not alive[j]:
                    continue
                rb_t, qb_t, ln_t = chain.seeds[j]
                if ln_t < ln_s * 0.95:
                    continue
                if (qb_s <= qb_t and qb_s + ln_s - qb_t >= ln_s >> 2 and
                        qb_t - qb_s != rb_t - rb_s):
                    confirm = False
                    break
                if (qb_t <= qb_s and qb_t + ln_t - qb_s >= ln_s >> 2 and
                        qb_s - qb_t != rb_s - rb_t):
                    confirm = False
                    break
            if confirm:
                alive[k] = False          # skip extension entirely
                continue
        # --- extension ---
        aw0 = aw1 = p.w
        score = 0
        if qb_s > 0:
            qs = query[:qb_s][::-1]
            ts = S[rmax0:rb_s][::-1]
            res = None
            for t in range(MAX_BAND_TRY):
                prev = score
                aw0 = p.w << t
                res = bsw_fn("L", k, t, qs, ts, ln_s * p.a, aw0)
                score = res.score
                if score == prev or res.max_off < (aw0 >> 1) + (aw0 >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= score - p.pen_clip5:
                qb, rb = qb_s - res.qle, rb_s - res.tle
                truesc = score
            else:
                qb, rb = 0, rb_s - res.gtle
                truesc = res.gscore
        else:
            score = truesc = ln_s * p.a
            qb, rb = 0, rb_s
        if qb_s + ln_s != l_query:
            qe0 = qb_s + ln_s
            re0 = rb_s + ln_s - rmax0
            sc0 = score
            res = None
            for t in range(MAX_BAND_TRY):
                prev = score
                aw1 = p.w << t
                res = bsw_fn("R", k, t, query[qe0:], rseq[re0:], sc0, aw1)
                score = res.score
                if score == prev or res.max_off < (aw1 >> 1) + (aw1 >> 2):
                    break
            if res.gscore <= 0 or res.gscore <= score - p.pen_clip3:
                qe, re = qe0 + res.qle, rmax0 + re0 + res.tle
                truesc += score - sc0
            else:
                qe, re = l_query, rmax0 + re0 + res.gtle
                truesc += res.gscore - sc0
        else:
            qe, re = l_query, rb_s + ln_s
        seedcov = sum(ln for (rbx, qbx, ln) in chain.seeds
                      if qbx >= qb and qbx + ln <= qe and
                      rbx >= rb and rbx + ln <= re)
        out.append(Alignment(qb=qb, qe=qe, rb=rb, re=re, score=score,
                             truesc=truesc, w=max(aw0, aw1),
                             seedcov=seedcov, seedlen0=ln_s))
    return out


# ---------------------------------------------------------------------
# BSW executors
# ---------------------------------------------------------------------

def bsw_immediate(p: BSWParams):
    """Baseline executor: scalar oracle, executed inline (read-major)."""
    def fn(side, seed_id, rnd, q, t, h0, w):
        if len(q) == 0 or len(t) == 0:
            # ksw_extend is never called with empty sequences in bwa; an
            # empty target means no room to extend: mirror a no-op result
            return ExtResult(h0, 0, 0, 0, -1, 0)
        return bsw_extend(q, t, h0, p, w)
    return fn


class BatchedBSWExecutor:
    """Optimized executor (paper §5.3): pre-plans every (seed, side, round)
    extension task, runs them as length-sorted inter-task batches, then
    serves the decision replay from the result table.  Each block runs
    through ``kernels.bsw.bsw_extend_kernel`` on ``device``."""

    def __init__(self, p: BSWParams, *, device, block: int = 256,
                 sort: bool = True):
        self.p = p
        self.device = device
        self.block = block
        self.sort = sort
        self.table: dict = {}
        self.stats = obs.Snapshot(tasks=0, cells_useful=0, cells_total=0)

    def _run(self, tasks: dict):
        """tasks: key -> (q, t, h0, w). Executes batched, fills self.table."""
        keys = list(tasks.keys())
        if not keys:
            return
        res, st = bsw_extend_tasks([tasks[k][0] for k in keys],
                                   [tasks[k][1] for k in keys],
                                   [tasks[k][2] for k in keys], self.p,
                                   ws=[tasks[k][3] for k in keys],
                                   block=self.block, sort=self.sort,
                                   batch_fn=functools.partial(
                                       kbsw.bsw_extend_kernel,
                                       device=self.device))
        for k, r in zip(keys, res):
            self.table[k] = r
        self.stats.merge_in(st)

    def plan_and_run(self, jobs):
        """jobs: list of (job_id, chain, query, idx).

        Phase 1: left round-0 for every non-skippable seed... note the
        containment skip depends on ALREADY-EXTENDED alignments, which the
        batched path cannot know upfront — so (like bwa-mem2) it extends
        EVERY seed and filters afterwards.  Rounds/h0 chaining is resolved
        with two batched waves per side.
        """
        p = self.p
        # ---- wave L0: all left extensions, round 0 ----
        Ltasks = {}
        meta = {}
        for (jid, chain, query, idx) in jobs:
            S = idx.seq
            rmax0, rmax1 = _chain_rmax(chain, len(query), idx, p, p.w)
            meta[jid] = (rmax0, rmax1)
            for k, (rb_s, qb_s, ln_s) in enumerate(chain.seeds):
                if qb_s > 0:
                    Ltasks[(jid, "L", k, 0)] = (query[:qb_s][::-1],
                                                S[rmax0:rb_s][::-1],
                                                ln_s * p.a, p.w)
        self._run(Ltasks)
        # ---- wave L1: band-doubled retries ----
        L1 = {}
        for key, (q, t, h0, w) in Ltasks.items():
            r = self.table[key]
            if not (r.score == 0 or r.max_off < (p.w >> 1) + (p.w >> 2)):
                L1[key[:3] + (1,)] = (q, t, h0, p.w << 1)
        self._run(L1)
        # ---- wave R0: rights, h0 from the seed's own left outcome ----
        Rtasks = {}
        for (jid, chain, query, idx) in jobs:
            rmax0, rmax1 = meta[jid]
            rseq = idx.seq[rmax0:rmax1]
            l_query = len(query)
            for k, (rb_s, qb_s, ln_s) in enumerate(chain.seeds):
                sc0 = self._left_score(jid, k, qb_s, ln_s)
                if qb_s + ln_s != l_query:
                    qe0 = qb_s + ln_s
                    re0 = rb_s + ln_s - rmax0
                    Rtasks[(jid, "R", k, 0)] = (query[qe0:], rseq[re0:],
                                                sc0, p.w)
        self._run(Rtasks)
        R1 = {}
        for key, (q, t, h0, w) in Rtasks.items():
            r = self.table[key]
            if not (r.score == h0 or r.max_off < (p.w >> 1) + (p.w >> 2)):
                R1[key[:3] + (1,)] = (q, t, h0, p.w << 1)
        self._run(R1)

    def _left_score(self, jid, k, qb_s, ln_s):
        """Replays bwa's left-extension round logic for seed k's score."""
        p = self.p
        if qb_s == 0:
            return ln_s * p.a
        score = 0
        for t in range(MAX_BAND_TRY):
            prev = score
            r = self.table.get((jid, "L", k, t))
            if r is None:
                break
            score = r.score
            aw0 = p.w << t
            if score == prev or r.max_off < (aw0 >> 1) + (aw0 >> 2):
                break
        return score

    def executor(self, jid):
        def fn(side, seed_id, rnd, q, t, h0, w):
            return self.table[(jid, side, seed_id, rnd)]
        return fn


# ---------------------------------------------------------------------
# Finalisation: primary marking, MAPQ, CIGAR — shared by both drivers
# ---------------------------------------------------------------------

def mark_and_finalize(alns: list[Alignment], query: np.ndarray,
                      S: np.ndarray, l_pac: int, p: BSWParams,
                      min_seed_len: int,
                      frep: float = 0.0,
                      min_score: int = 30,
                      all_hits: bool = False,
                      softclip_supp: bool = False) -> list[Alignment]:
    """Marking, then each emitted region finalized on the host
    (``host_align``: ``global_align_cigar`` region by region), as the
    original organisation does."""
    out = mark_regions(alns, p, min_score=min_score, all_hits=all_hits)
    cigars = align_regions([(a, query) for a in out], S, p, host_align)
    return finish_regions(out, cigars, query, S, l_pac, p, min_seed_len,
                          frep=frep, softclip_supp=softclip_supp)


def mark_regions(alns: list[Alignment], p: BSWParams, *,
                 min_score: int = 30,
                 all_hits: bool = False) -> list[Alignment]:
    """The marking step of ``mark_and_finalize``: regions sorted, the
    secondaries marked, and the ones bwa emits picked (none finalized)."""
    if not alns:
        return []
    alns = sorted(alns, key=lambda a: (-a.score, a.qb, a.rb))
    tmp = max(p.a + p.b, p.o_del + p.e_del, p.o_ins + p.e_ins)
    z: list[int] = [0]
    for i in range(1, len(alns)):
        placed = False
        for j in z:
            b = max(alns[j].qb, alns[i].qb)
            e = min(alns[j].qe, alns[i].qe)
            if e > b:
                min_l = min(alns[i].qe - alns[i].qb, alns[j].qe - alns[j].qb)
                if e - b >= min_l * 0.50:          # significant overlap
                    if alns[j].sub == 0:
                        alns[j].sub = alns[i].score
                    if alns[j].score - alns[i].score <= tmp:
                        alns[i].secondary = j
                        placed = True
                        break
        if not placed:
            z.append(i)
    # Emission (bwa mem_reg2sam): primaries above -T always; secondaries
    # only under -a (flag 0x100, MAPQ 0); non-first primaries are
    # supplementary (flag 0x800) and hard-clipped unless -Y.
    return [a for a in alns if a.truesc >= min_score
            and (a.secondary < 0 or all_hits)]


def finish_regions(out: list[Alignment], cigars: list, query: np.ndarray,
                   S: np.ndarray, l_pac: int, p: BSWParams,
                   min_seed_len: int, *, frep: float = 0.0,
                   softclip_supp: bool = False) -> list[Alignment]:
    """The rest of ``mark_and_finalize`` for the emitted regions ``out``
    of one read, each with its CIGAR from ``global_align_cigar``:
    ``apply_cigar``, MAPQ and the supplementary flags, in emission
    order."""
    n_primary = 0
    for a, cig in zip(out, cigars, strict=True):
        apply_cigar(a, query, S, l_pac, cig)
        a.mapq = approx_mapq(a, p, min_seed_len) if a.secondary < 0 else 0
        a.frac_rep = frep      # per-read, carried on every region like bwa
        if a.secondary < 0:
            a.supplementary = n_primary > 0
            a.hard_clip = a.supplementary and not softclip_supp
            n_primary += 1
    return out


def finalize_alignment(a: Alignment, query: np.ndarray, S: np.ndarray,
                       l_pac: int, p: BSWParams):
    """One region finalized on the host, as the reference's function of
    this name does; ``run_se_batched`` and ``merge_rescues`` finalize a
    batch's regions together (``align_regions``, then
    ``apply_cigar``)."""
    _, cig = global_align_cigar(*finalize_task(a, query, S), p)
    apply_cigar(a, query, S, l_pac, cig)


def finalize_task(a: Alignment, query: np.ndarray, S: np.ndarray):
    """``(q, t, w)``: the banded global alignment that finalizes region
    ``a`` (its query and reference segments, codes clipped to 0..4)."""
    return (np.clip(query[a.qb:a.qe], 0, 4), np.clip(S[a.rb:a.re], 0, 4),
            a.w)


def apply_cigar(a: Alignment, query: np.ndarray, S: np.ndarray,
                l_pac: int, cig: list):
    """Finalize region ``a`` with its CIGAR from ``global_align_cigar``:
    strand, position, the reverse strand's flip, NM."""
    qseg = query[a.qb:a.qe]
    tseg = S[a.rb:a.re]
    a.is_rev = a.rb >= l_pac
    if a.is_rev:
        a.pos = 2 * l_pac - a.re
        cig = cig[::-1]
        # SAM reports the reverse-complemented read: soft clips swap
        L = len(query)
        a.qb, a.qe = L - a.qe, L - a.qb
    else:
        a.pos = a.rb
    a.cigar = cig
    # NM: walk cigar
    nm = 0
    qi, ti = 0, 0
    qw = qseg if not a.is_rev else (3 - qseg[::-1]) % 5
    tw = tseg if not a.is_rev else (3 - tseg[::-1]) % 5
    for (n, op) in cig:
        if op == "M":
            nm += int((qw[qi:qi + n] != tw[ti:ti + n]).sum())
            qi += n
            ti += n
        elif op == "I":
            nm += n
            qi += n
        else:
            nm += n
            ti += n
    a.nm = nm
    a.secondary_flag = a.secondary >= 0


def align_regions(regions, S: np.ndarray, p: BSWParams, align) -> list:
    """The CIGARs of every ``(a, query)`` region, in order, from ONE call
    of ``align`` (``host_align``, or ``kernels.galign.global_align_batch``
    on a device) over all their ``finalize_task``s."""
    tasks = [finalize_task(a, q, S) for a, q in regions]
    return [cig for _, cig in align(tasks, p)]


def host_align(tasks, p: BSWParams) -> list:
    """``global_align_cigar`` on the host, task by task: the original
    organisation's finalize (the ``baseline`` engine's)."""
    return [global_align_cigar(q, t, w, p) for q, t, w in tasks]


def approx_mapq(a: Alignment, p: BSWParams, min_seed_len: int) -> int:
    import math
    sub = a.sub if a.sub else min_seed_len * p.a
    sub = max(sub, a.csub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - float(l * p.a - a.score) / (p.a + p.b) / l
    if a.score == 0:
        mapq = 0
    else:
        coef_len, coef_fac = 50, math.log(50)
        t = 1.0 if l < coef_len else coef_fac / math.log(l)
        t *= identity * identity
        mapq = int(6.02 * (a.score - sub) / p.a * t * t + 0.499)
    if identity < 0.95:
        mapq = int(mapq * identity * identity + 0.499)
    return max(0, min(mapq, 60))


# ---------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineOptions:
    mem: MemOptions = MemOptions()
    chain: ChainOptions = ChainOptions()
    bsw: BSWParams = BSWParams()
    bsw_block: int = 256
    bsw_sort: bool = True
    min_score: int = 30             # emission threshold (bwa -T)
    all_hits: bool = False          # bwa -a: also emit secondary records
    softclip_supp: bool = False     # bwa -Y: soft-clip supplementary
    device: str = "cuda"            # where SMEM, SAL and BSW run


def run_se_baseline(idx: FMIndex, reads: np.ndarray,
                    opt: PipelineOptions = PipelineOptions()):
    """Original organisation: per-read, the scalar oracles on the host
    (SMEM over ``FMIndex.occ``, one compressed-SA LF walk a lookup,
    ``bsw_extend`` inline), whatever ``opt.device`` says.  Returns (list
    per read of Alignment, stats)."""
    S = idx.seq
    l_pac = idx.n_ref
    edges = contig_edges(idx)
    elist = edges.tolist()          # scalar bisect beats np in this loop
    stats = obs.Snapshot(sa_lookups=0, bsw_tasks=0)
    bsw_fn_factory = bsw_immediate(opt.bsw)
    results = []
    for r in range(len(reads)):
        q = reads[r]
        with obs.span("smem"):
            mems = smem_mod.collect_smems(idx, q, opt.mem)
            frep = smem_mod.frac_rep(mems, len(q), opt.mem.max_occ)
        # SAL (compressed baseline, one lookup at a time)
        with obs.span("sal"):
            seeds = []
            for (k, l, s, qb, qe) in mems:
                step = s // opt.mem.max_occ if s > opt.mem.max_occ else 1
                cnt = 0
                kk = 0
                while kk < s and cnt < opt.mem.max_occ:
                    rbeg, _ = idx.sa_lookup_compressed(k + kk)
                    stats["sa_lookups"] += 1
                    slen = qe - qb
                    # same-block test (bwa's boundary-bridging seed drop;
                    # the scalar form of core.contig.seed_within_contig)
                    if bisect.bisect_right(elist, rbeg) == \
                            bisect.bisect_right(elist, rbeg + slen - 1):
                        seeds.append((int(rbeg), qb, slen))
                    kk += step
                    cnt += 1
        with obs.span("chain"):
            chains = filter_chains(chain_seeds(seeds, l_pac, opt.chain,
                                               edges), opt.chain)
        alns: list[Alignment] = []
        counting = [0]

        def counting_fn(side, seed_id, rnd, qq, tt, h0, w,
                        _f=bsw_fn_factory, _c=counting):
            _c[0] += 1
            return _f(side, seed_id, rnd, qq, tt, h0, w)
        with obs.span("bsw"):
            for c in chains:
                alns.extend(chain2aln(c, q, idx, opt.bsw, counting_fn))
        stats["bsw_tasks"] += counting[0]
        with obs.span("finalize"):
            results.append(mark_and_finalize(alns, q, S, l_pac, opt.bsw,
                                             opt.mem.min_seed_len, frep=frep,
                                             min_score=opt.min_score,
                                             all_hits=opt.all_hits,
                                             softclip_supp=opt.softclip_supp))
    return results, stats


def run_se_batched(idx: FMIndex, reads: np.ndarray,
                   opt: PipelineOptions = PipelineOptions(), *,
                   occ: OccConfig | None = None):
    """Paper's organisation (Fig 2 right): stage-major over the batch,
    SMEM's rounds through the round kernel ``occ`` names (the engine's
    sweep picks it; omitted, ``DEFAULT_CANDIDATE`` on ``opt.device``,
    what the sweep gives on the CPU)."""
    S = idx.seq
    l_pac = idx.n_ref
    edges = contig_edges(idx)
    R, L = reads.shape
    lens = np.full(R, L, np.int64)
    occ = occ or OccConfig(*DEFAULT_CANDIDATE, opt.device)
    # Stage 1: batched SMEM, every round one launch of the fmocc kernel
    with obs.span("smem", reads=R):
        mems = smem_mod.collect_smems_batch(idx, reads, lens, opt.mem,
                                            occ=occ)
    # Stage 2: batched SAL (uncompressed SA, one gather for everything)
    with obs.span("sal"):
        seeds_per_read, n_lookups = sal_mod.seeds_from_intervals(
            idx, mems, opt.mem.max_occ, device=opt.device)
    # Stage 3: chaining (shared scalar code)
    with obs.span("chain"):
        chains_per_read = []
        jobs = []
        for r in range(R):
            seeds = [(rb, qb, ln) for (rb, qb, ln, s) in seeds_per_read[r]]
            chains = filter_chains(chain_seeds(seeds, l_pac, opt.chain,
                                               edges), opt.chain)
            chains_per_read.append(chains)
            for ci, c in enumerate(chains):
                jobs.append(((r, ci), c, reads[r], idx))
    # Stage 4: batched inter-task BSW with length sorting
    execu = BatchedBSWExecutor(opt.bsw, device=opt.device,
                               block=opt.bsw_block, sort=opt.bsw_sort)
    with obs.span("bsw", jobs=len(jobs)):
        execu.plan_and_run(jobs)
    # Stage 5: decision replay + SAM-FORM: every read's emitted regions
    # marked first, then all of their CIGARs in one galign launch
    with obs.span("finalize"):
        with obs.span("finalize.replay"):
            emitted = []
            for r in range(R):
                alns: list[Alignment] = []
                for ci, c in enumerate(chains_per_read[r]):
                    alns.extend(chain2aln(c, reads[r], idx, opt.bsw,
                                          execu.executor((r, ci))))
                emitted.append(mark_regions(alns, opt.bsw,
                                            min_score=opt.min_score,
                                            all_hits=opt.all_hits))
        cigars = iter(align_regions(
            [(a, reads[r]) for r in range(R) for a in emitted[r]], S,
            opt.bsw, functools.partial(kgalign.global_align_batch,
                                       device=opt.device)))
        with obs.span("finalize.cigar"):
            results = []
            for r in range(R):
                frep = smem_mod.frac_rep(mems[r], L, opt.mem.max_occ)
                results.append(finish_regions(
                    emitted[r], [next(cigars) for _ in emitted[r]],
                    reads[r], S, l_pac, opt.bsw, opt.mem.min_seed_len,
                    frep=frep, softclip_supp=opt.softclip_supp))
    stats = obs.Snapshot(sa_lookups=n_lookups, bsw_tasks=execu.stats["tasks"],
                         cells_useful=execu.stats["cells_useful"],
                         cells_total=execu.stats["cells_total"])
    return results, stats
