"""SAM-FORM stage: CIGAR generation + SAM record formatting.

CIGARs come from a banded global alignment with affine gaps (ksw_global-
style) over the final chosen region.  This stage is shared verbatim by the
baseline and optimized pipelines (2.5-2.9% of runtime in paper Table 1).
"""

from __future__ import annotations

import numpy as np

from .bsw import BSWParams
from .contig import DEFAULT_RNAME, translate

_OPS = "MID"


def global_align_cigar(q: np.ndarray, t: np.ndarray, w: int,
                       p: BSWParams) -> tuple[int, list[tuple[int, str]]]:
    """Banded global affine-gap alignment with traceback -> (score, cigar).

    q aligned fully to t; band of half-width w around the diagonal scaled
    to the length difference (as ksw_global does).
    """
    n, m = len(q), len(t)
    if n == 0:
        return (-p.o_del - p.e_del * m if m else 0), ([(m, "D")] if m else [])
    if m == 0:
        return -p.o_ins - p.e_ins * n, [(n, "I")]
    mat = p.matrix()
    w = max(w, abs(n - m) + 3)
    NEG = -(1 << 28)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)   # gap in query (deletion, consume t)
    F = np.full((n + 1, m + 1), NEG, np.int64)   # gap in target (insertion, consume q)
    H[0, 0] = 0
    for j in range(1, min(m, w) + 1):
        E[0, j] = -(p.o_del + p.e_del * j)
        H[0, j] = E[0, j]
    for i in range(1, min(n, w) + 1):
        F[i, 0] = -(p.o_ins + p.e_ins * i)
        H[i, 0] = F[i, 0]
    for i in range(1, n + 1):
        jlo = max(1, i - w)
        jhi = min(m, i + w)
        for j in range(jlo, jhi + 1):
            E[i, j] = max(E[i, j - 1] - p.e_del, H[i, j - 1] - p.o_del - p.e_del)
            F[i, j] = max(F[i - 1, j] - p.e_ins, H[i - 1, j] - p.o_ins - p.e_ins)
            diag = H[i - 1, j - 1] + mat[int(q[i - 1]), int(t[j - 1])]
            H[i, j] = max(diag, E[i, j], F[i, j])
    # traceback
    i, j = n, m
    ops: list[str] = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if i > 0 and j > 0 and H[i, j] == (
                    H[i - 1, j - 1] + mat[int(q[i - 1]), int(t[j - 1])]):
                ops.append("M")
                i -= 1
                j -= 1
            elif j > 0 and H[i, j] == E[i, j]:
                state = "E"
            elif i > 0 and H[i, j] == F[i, j]:
                state = "F"
            else:  # out-of-band corner: force remaining as gaps
                if i == 0:
                    ops.append("D"); j -= 1
                elif j == 0:
                    ops.append("I"); i -= 1
                else:
                    ops.append("M"); i -= 1; j -= 1
        elif state == "E":
            ops.append("D")
            if E[i, j] == H[i, j - 1] - p.o_del - p.e_del:
                state = "H"
            j -= 1
        else:
            ops.append("I")
            if F[i, j] == H[i - 1, j] - p.o_ins - p.e_ins:
                state = "H"
            i -= 1
    ops.reverse()
    cigar: list[tuple[int, str]] = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return int(H[n, m]), cigar


def _cigar_str(read: np.ndarray, aln, hard_clip: bool = False) -> str:
    """CIGAR with clips from the alignment's query interval.

    Clips are soft (``S``) except for supplementary records without
    ``-Y``, which bwa hard-clips (``H``).
    """
    clip = "H" if hard_clip else "S"
    cig = ""
    if aln.qb > 0:
        cig += f"{aln.qb}{clip}"
    cig += "".join(f"{n}{op}" for n, op in aln.cigar)
    tail = len(read) - aln.qe
    if tail > 0:
        cig += f"{tail}{clip}"
    return cig


def cigar_reflen(aln) -> int:
    """Reference bases consumed by the alignment (M/D ops)."""
    return sum(n for n, op in aln.cigar if op in ("M", "D"))


def format_sam(qname: str, read: np.ndarray, aln, idx=None) -> str:
    """One SAM line from an Alignment record (see pipeline.py).

    ``idx`` (any FMIndex/ContigIndex) supplies the global->(RNAME, local
    pos) translation; without it the single-reference name is used.
    """
    if aln is None:
        return f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*"
    flag = 16 if aln.is_rev else 0
    if aln.secondary >= 0:
        flag |= 0x100
    if getattr(aln, "supplementary", False):
        flag |= 0x800
    rname, pos = (DEFAULT_RNAME, aln.pos) if idx is None \
        else translate(idx, aln.pos)
    cig = _cigar_str(read, aln, hard_clip=getattr(aln, "hard_clip", False))
    return (f"{qname}\t{flag}\t{rname}\t{pos + 1}\t{aln.mapq}\t{cig}\t*\t0\t0"
            f"\t*\t*\tAS:i:{aln.score}\tNM:i:{aln.nm}")


def format_sam_pe(qname: str, read: np.ndarray, aln, mate, *,
                  first: bool, proper: bool, idx=None) -> str:
    """One end of a read pair: FLAG bits 0x1/0x2/0x8/0x20/0x40/0x80 plus
    RNEXT/PNEXT/TLEN (bwa mem_aln2sam's mate fields).

    TLEN follows bwa exactly: signed distance between the two ends'
    leftmost/rightmost reference coordinates, ``-(p0 - p1 + sign)`` with
    p = pos (+ reflen - 1 on the reverse strand).  Mates on DIFFERENT
    contigs get an explicit RNEXT (never ``=``) and TLEN=0, as in bwa —
    such pairs are by construction not proper (no 0x2).
    """
    def _tr(pos):
        return (DEFAULT_RNAME, int(pos)) if idx is None \
            else translate(idx, pos)

    flag = 0x1 | (0x40 if first else 0x80)
    if aln is None:
        flag |= 0x4
        if mate is not None:
            if mate.is_rev:
                flag |= 0x20
            # SAM convention: an unmapped end takes its mate's coordinate
            mrname, mpos = _tr(mate.pos)
            return (f"{qname}\t{flag}\t{mrname}\t{mpos + 1}\t0\t*\t="
                    f"\t{mpos + 1}\t0\t*\t*")
        flag |= 0x8
        return f"{qname}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t*\t*"
    if aln.is_rev:
        flag |= 0x10
    if proper:
        flag |= 0x2
    rname, pos = _tr(aln.pos)
    if mate is None:
        flag |= 0x8
        rnext, pnext, tlen = "=", pos + 1, 0
    else:
        if mate.is_rev:
            flag |= 0x20
        mrname, mpos = _tr(mate.pos)
        pnext = mpos + 1
        if mrname == rname:
            rnext = "="
            p0 = aln.pos + (cigar_reflen(aln) - 1 if aln.is_rev else 0)
            p1 = mate.pos + (cigar_reflen(mate) - 1 if mate.is_rev else 0)
            tlen = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
        else:
            rnext, tlen = mrname, 0
    cig = _cigar_str(read, aln)
    tags = f"AS:i:{aln.score}\tNM:i:{aln.nm}"
    if getattr(aln, "rescued", False):
        tags += "\tXR:i:1"
    return (f"{qname}\t{flag}\t{rname}\t{pos + 1}\t{aln.mapq}\t{cig}"
            f"\t{rnext}\t{pnext}\t{tlen}\t*\t*\t{tags}")
