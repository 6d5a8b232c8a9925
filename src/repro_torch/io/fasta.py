"""FASTA reading/writing (plain and gzipped) + reference encoding.

``load_reference`` is the ``bwa index`` ingestion path: contigs are read
in file order and encoded to 0..3 codes, with every IUPAC-ambiguity
letter (N, R, Y, ...) replaced by a *random* base drawn from one RNG
seeded at a fixed value — exactly bwa's behaviour when packing the
reference (``bns_fasta2bntseq`` runs ``srand48(11)`` and substitutes
``lrand48() & 3``), so an ambiguous reference still gets a fully
searchable FM-index and the substitution is reproducible run-to-run.
The resulting (name, codes) pairs feed ``core.contig.build_contig_index``
directly.
"""

from __future__ import annotations

import gzip

import numpy as np

# bwa seeds srand48(11) before packing the reference; we mirror the fixed
# seed (the RNG itself is numpy's, so substituted bases differ from bwa's,
# but are deterministic for this tool).
REFERENCE_AMBIG_SEED = 11

_GZIP_MAGIC = b"\x1f\x8b"

# 0..3 for acgt/ACGT; 4 for every other IUPAC ambiguity letter
# (NRYSWKMBDHV and U=T handled explicitly); 255 = invalid.
_REF_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _pair in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _b in _pair:
        _REF_CODE[_b] = _i
for _b in b"UuNnRrYySsWwKkMmBbDdHhVv":
    if _REF_CODE[_b] == 255:
        _REF_CODE[_b] = 4
_REF_CODE[ord("U")] = _REF_CODE[ord("u")] = 3        # uracil reads as T


def open_text(path, mode: str = "rt"):
    """Open ``path`` as text, transparently un/gzipping.

    Reads sniff the gzip magic (so a mis-named ``.fa`` that is really
    gzipped still works); writes choose gzip by a ``.gz`` suffix.
    """
    path = str(path)
    if "r" in mode:
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic == _GZIP_MAGIC:
            return gzip.open(path, "rt")
        return open(path, "r")
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path) -> list[tuple[str, str]]:
    """Parse a (possibly gzipped) FASTA file -> [(name, sequence), ...].

    The record name is the first whitespace-delimited token of the header
    (bwa's convention); sequence lines are concatenated verbatim.
    """
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    with open_text(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                header = line[1:].strip()
                if not header:
                    raise ValueError(f"{path}:{lineno}: empty FASTA header")
                name = header.split()[0]
                chunks = []
            else:
                if name is None:
                    raise ValueError(
                        f"{path}:{lineno}: sequence before first '>' header")
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    if not out:
        raise ValueError(f"{path}: no FASTA records")
    return out


def write_fasta(path, records, *, width: int = 60) -> None:
    """Write (name, sequence-string) records as FASTA (gzip on ``.gz``)."""
    with open_text(path, "wt") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


def encode_reference(seq: str, rng: np.random.Generator) -> np.ndarray:
    """One contig's sequence -> (n,) uint8 codes in 0..3.

    Ambiguous IUPAC letters become random bases drawn from ``rng`` (the
    caller passes ONE generator for the whole reference so the
    substitution stream is a deterministic function of file order).
    """
    codes = _REF_CODE[np.frombuffer(seq.encode(), dtype=np.uint8)].copy()
    bad = codes == 255
    if bad.any():
        j = int(np.nonzero(bad)[0][0])
        raise ValueError(f"invalid reference character {seq[j]!r}")
    amb = codes == 4
    if amb.any():
        codes[amb] = rng.integers(0, 4, size=int(amb.sum()), dtype=np.uint8)
    return codes


def load_reference(path, *, seed: int = REFERENCE_AMBIG_SEED
                   ) -> list[tuple[str, np.ndarray]]:
    """FASTA -> [(name, codes 0..3)] ready for ``build_contig_index``."""
    rng = np.random.default_rng(seed)
    return [(name, encode_reference(seq, rng))
            for name, seq in read_fasta(path)]
