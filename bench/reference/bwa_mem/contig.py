"""Multi-contig reference support: ContigIndex + coordinate translation.

Real references (the paper benchmarks against the human genome, Table 3)
are multi-contig FASTAs.  BWA concatenates the contigs into one packed
sequence (the ``.pac``), builds ONE FM-index over the concatenation (plus
its reverse complement) and translates every global position back to
(contig, local position) at SAM-emission time (``bns_pos2rid``/
``bns_depos``).  This module mirrors that design on top of ``FMIndex``:

* ``build_contig_index`` concatenates the contigs, builds the FM-index
  over S = R·revcomp(R) and records per-contig names/offsets/lengths.
* The doubled reference decomposes into 2C *blocks* — each contig's
  forward copy [off, off+len) and its mirrored reverse copy
  [2·l_pac-off-len, 2·l_pac-off).  ``contig_edges`` exposes the sorted
  block boundaries; seeds, chains and BSW extension windows must stay
  inside one block (bwa drops ``rid < 0`` cross-boundary hits).
* ``translate`` maps a forward-strand global position to (RNAME, local
  pos); ``contig_id`` classifies a doubled-space position strand-
  agnostically (used by the PE layer: pairs are only "proper" on the
  same contig).

A plain single-sequence ``FMIndex`` is the degenerate C=1 case: every
helper below falls back to blocks {[0, l_pac), [l_pac, 2·l_pac)} and the
reference name ``"ref"``, which keeps the single-contig SAM output
byte-identical to the pre-multi-contig pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .fmindex import FMIndex, build_index

DEFAULT_RNAME = "ref"


@dataclasses.dataclass
class ContigIndex(FMIndex):
    """FM-index over concatenated contigs + the coordinate metadata."""
    names: tuple = ()
    offsets: np.ndarray | None = None   # (C,) contig starts in R
    lengths: np.ndarray | None = None   # (C,)
    edges: np.ndarray | None = None     # (2C+1,) sorted block boundaries


def build_contig_index(contigs) -> ContigIndex:
    """Build one FM-index over the concatenation of ``contigs``.

    ``contigs``: dict name -> codes, or iterable of (name, codes) pairs;
    codes are (n,) uint8 in 0..3 (as for ``build_index``).
    """
    items = list(contigs.items()) if isinstance(contigs, dict) \
        else list(contigs)
    if not items:
        raise ValueError("need at least one contig")
    names = tuple(str(n) for n, _ in items)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate contig names: {names}")
    arrs = [np.asarray(a, dtype=np.uint8) for _, a in items]
    lengths = np.array([len(a) for a in arrs], dtype=np.int64)
    if (lengths == 0).any():
        raise ValueError("empty contig")
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    base = build_index(np.concatenate(arrs))
    return with_contigs(base, names, offsets, lengths)


def with_contigs(base: FMIndex, names, offsets, lengths) -> ContigIndex:
    """Attach a contig table to a base ``FMIndex`` (serialization hook:
    ``repro.io.store`` persists the table as JSON metadata and reattaches
    it here on load; ``edges`` is derived from offsets + l_pac)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if not (len(names) == len(offsets) == len(lengths)):
        raise ValueError("contig table fields disagree on contig count")
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(FMIndex)}
    return ContigIndex(**fields, names=tuple(names), offsets=offsets,
                       lengths=lengths,
                       edges=make_edges(offsets, int(base.n_ref)))


def contig_table(idx) -> dict | None:
    """JSON-serializable contig metadata of ``idx`` (None for a plain
    single-sequence FMIndex) — the store's counterpart of
    ``with_contigs``."""
    names = getattr(idx, "names", None)
    if names is None:
        return None
    return {"names": list(names),
            "offsets": [int(o) for o in idx.offsets],
            "lengths": [int(ln) for ln in idx.lengths]}


def make_edges(offsets: np.ndarray, l_pac: int) -> np.ndarray:
    """Sorted block boundaries of the doubled reference.

    Forward blocks start at the contig offsets; because the contigs are
    concatenated contiguously, the mirrored reverse blocks start at
    2·l_pac - offset for each non-zero offset.  C contigs -> 2C blocks ->
    2C+1 edges: [0, o_1, .., o_{C-1}, l_pac, 2l-o_{C-1}, .., 2l-o_1, 2l].
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    rev = (2 * l_pac - offsets[1:])[::-1]
    return np.concatenate([offsets, [l_pac], rev, [2 * l_pac]])


def contig_edges(idx) -> np.ndarray:
    """Block boundaries for any index (C=1 fallback for plain FMIndex,
    including indexes pickled before the ``edges`` field existed)."""
    e = getattr(idx, "edges", None)
    if e is None:
        n = int(idx.n_ref)
        e = np.array([0, n, 2 * n], dtype=np.int64)
    return e


def block_bounds(idx, pos: int) -> tuple[int, int]:
    """[lo, hi) of the strand-specific contig block containing ``pos``
    (doubled-reference coordinates)."""
    e = contig_edges(idx)
    j = int(np.searchsorted(e, pos, side="right")) - 1
    return int(e[j]), int(e[j + 1])


def fwd_pos(l_pac: int, pos: int) -> int:
    """Project a doubled-space position onto the forward strand."""
    return pos if pos < l_pac else 2 * l_pac - 1 - pos


def contig_id(idx, pos: int) -> int:
    """Strand-agnostic contig id of a doubled-space position."""
    offs = getattr(idx, "offsets", None)
    if offs is None:
        return 0
    p = fwd_pos(int(idx.n_ref), int(pos))
    return int(np.searchsorted(offs, p, side="right")) - 1


def same_contig(idx, pos1: int, pos2: int) -> bool:
    return contig_id(idx, pos1) == contig_id(idx, pos2)


def translate(idx, pos: int) -> tuple[str, int]:
    """Forward-strand global position -> (RNAME, 0-based local position).

    This is bns_depos+bns_pos2rid at SAM-emission time; ``Alignment.pos``
    is already forward-strand, so no strand projection happens here.
    """
    offs = getattr(idx, "offsets", None)
    if offs is None:
        return DEFAULT_RNAME, int(pos)
    cid = int(np.searchsorted(offs, pos, side="right")) - 1
    return idx.names[cid], int(pos - offs[cid])


def sam_header(idx, *, extra: list[str] | None = None) -> list[str]:
    """@HD + per-contig @SQ lines (+ caller-supplied extra lines)."""
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    names = getattr(idx, "names", None)
    if names is None:
        lines.append(f"@SQ\tSN:{DEFAULT_RNAME}\tLN:{int(idx.n_ref)}")
    else:
        for name, ln in zip(names, idx.lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    return lines + list(extra or [])
