"""Pair scoring and selection (mem_pair port) + pair-aware SAM emission.

A candidate pair (one alignment per end) is scored as the sum of the two
alignment scores plus an insert-size log-likelihood penalty under the
estimated distribution:

    q = s1 + s2 + 0.721 * ln(2 * erfc(|ns| / sqrt(2))) * a

where ``ns`` is the insert size's z-score for the pair's orientation
(0.721 = 1/ln(4) converts nats to the scoring-matrix scale, as in bwa).
The best-scoring consistent pair wins the pairing only if it beats the
unpaired alternative ``best1 + best2 - pen_unpaired``; otherwise each end
keeps its own best alignment and the pair is not marked proper.

Ends on DIFFERENT contigs never form a consistent pair (no defined
insert size), mirroring mem_pair's same-rid requirement.

When a proper pair wins, bwa blends each end's single-end MAPQ with the
pair-level confidence (mem_sam_pe's q_pe/q_se logic, ported in
``blend_mapq``): an end whose own placement is ambiguous inherits up to
+40 from the pair evidence, capped by the pair MAPQ and by the
tandem-repeat-adjusted raw MAPQ.  This is what gives rescued mates a
pair-aware MAPQ instead of their (meaningless) SE-style one.
"""

from __future__ import annotations

import dataclasses
import math

from .contig import same_contig
from .sam import format_sam_pe
from .pestat import PairStat, infer_dir

_M_SQRT1_2 = 1.0 / math.sqrt(2.0)
MAX_PAIR_CAND = 8
MAPQ_SE_BONUS = 40               # max pair-evidence boost of an end's MAPQ


def raw_mapq(diff: int, a_match: int) -> int:
    """bwa's raw_mapq macro: 6.02 * score-diff / match-score."""
    return int(6.02 * diff / a_match + 0.499)


def pair_score(a1, a2, pes: list[PairStat], idx, a_match: int):
    """(q, r, dist) if the two alignments form a consistent pair under a
    non-failed orientation, else None."""
    if not same_contig(idx, a1.rb, a2.rb):
        return None
    r, d = infer_dir(int(idx.n_ref), a1.rb, a2.rb)
    if pes[r].failed or not (pes[r].low <= d <= pes[r].high):
        return None
    ns = (d - pes[r].avg) / pes[r].std
    prob = max(2.0 * math.erfc(abs(ns) * _M_SQRT1_2), 1e-300)
    q = a1.score + a2.score + 0.721 * math.log(prob) * a_match
    return int(q + 0.499), r, d


def select_pair(regs1: list, regs2: list, pes: list[PairStat], idx,
                a_match: int):
    """Best consistent (a1, a2, q, sub) over non-secondary candidates of
    both ends, or None.  ``sub`` is the second-best consistent pair's
    score (0 if unique), feeding the q_pe pair MAPQ exactly like
    mem_pair's ``*sub`` output.  Sorting on (-q, i, j) keeps ties
    deterministic (lowest i, then lowest j)."""
    c1 = [a for a in regs1 if a.secondary < 0][:MAX_PAIR_CAND]
    c2 = [a for a in regs2 if a.secondary < 0][:MAX_PAIR_CAND]
    cand = []
    for i, a1 in enumerate(c1):
        for j, a2 in enumerate(c2):
            s = pair_score(a1, a2, pes, idx, a_match)
            if s is not None:
                cand.append((s[0], i, j, a1, a2))
    if not cand:
        return None
    cand.sort(key=lambda t: (-t[0], t[1], t[2]))
    sub = cand[1][0] if len(cand) > 1 else 0
    return cand[0][3], cand[0][4], cand[0][0], sub


def blend_mapq(q_pair: int, sub_pair: int, score_un: int, mapq1: int,
               mapq2: int, score1: int, csub1: int, score2: int,
               csub2: int, a_match: int, frac_rep1: float = 0.0,
               frac_rep2: float = 0.0) -> tuple[int, int]:
    """mem_sam_pe's pair-aware MAPQ: blend each end's SE MAPQ with the
    pair-level MAPQ ``q_pe``.

    q_pe scores the winning pair against the runner-up hypothesis (second
    best pair OR the unpaired alternative, whichever is stronger), scaled
    down by ``1 - (frac_rep1 + frac_rep2)/2`` — the two ends' repeat
    fractions from the SMEM stage (``core.smem.frac_rep``): pair evidence
    from repeat-dominated reads is discounted, since an insert-consistent
    placement inside a repeat array says little.  An end whose SE MAPQ is
    below q_pe is lifted to min(q_pe, q_se + 40), then capped by the
    tandem-repeat raw MAPQ of its own alignment.
    """
    subo = max(sub_pair, score_un)
    q_pe = min(max(raw_mapq(q_pair - subo, a_match), 0), 60)
    q_pe = int(q_pe * (1.0 - 0.5 * (frac_rep1 + frac_rep2)) + 0.499)
    out = []
    for q_se, score, csub in ((mapq1, score1, csub1),
                              (mapq2, score2, csub2)):
        if q_se < q_pe:
            q_se = min(q_pe, q_se + MAPQ_SE_BONUS)
        q_se = min(q_se, raw_mapq(score - csub, a_match))
        out.append(max(q_se, 0))
    return out[0], out[1]


def emit_pair(qname: str, read1, read2, regs1: list, regs2: list,
              pes: list[PairStat], idx, a_match: int,
              pen_unpaired: int, *,
              mapq_blend: bool = True) -> tuple[list[str], bool]:
    """Two SAM lines for one pair + whether it was emitted proper.

    mem_sam_pe's decision: take the best consistent pair when its score
    beats the unpaired sum minus the unpaired penalty (applying the
    q_pe/q_se MAPQ blend to the winning ends); fall back to each end's
    own best alignment otherwise.
    """
    b1 = regs1[0] if regs1 else None
    b2 = regs2[0] if regs2 else None
    a1, a2, proper = b1, b2, False
    if not all(s.failed for s in pes):
        sel = select_pair(regs1, regs2, pes, idx, a_match)
        if sel is not None:
            score_un = ((b1.score if b1 else 0) + (b2.score if b2 else 0)
                        - pen_unpaired)
            if sel[2] > score_un:
                a1, a2, proper = sel[0], sel[1], True
                if mapq_blend:
                    # frac_rep of each end's BEST region (bwa reads
                    # a[i].a[0].frac_rep, not the winning pair's region)
                    m1, m2 = blend_mapq(
                        sel[2], sel[3], score_un, a1.mapq, a2.mapq,
                        a1.score, a1.csub, a2.score, a2.csub, a_match,
                        frac_rep1=getattr(b1, "frac_rep", 0.0),
                        frac_rep2=getattr(b2, "frac_rep", 0.0))
                    # emit blended copies: the caller's result lists keep
                    # their SE MAPQ (the blend is not idempotent)
                    a1 = dataclasses.replace(a1, mapq=m1)
                    a2 = dataclasses.replace(a2, mapq=m2)
    lines = [format_sam_pe(qname, read1, a1, a2, first=True, proper=proper,
                           idx=idx),
             format_sam_pe(qname, read2, a2, a1, first=False, proper=proper,
                           idx=idx)]
    return lines, proper
