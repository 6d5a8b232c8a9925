"""FASTQ reading/writing (plain and gzipped), single and paired.

Three ingestion shapes, mirroring bwa mem's accepted inputs:

* ``read_fastq``              — one file, one record per read;
* ``read_fastq_paired``       — synchronized R1/R2 files (``reads_1.fq``
  + ``reads_2.fq``), lockstep iteration with name-consistency checks;
* ``read_fastq_interleaved``  — one file with R1/R2 alternating
  (bwa's ``-p`` smart pairing).

Read sequences encode A/C/G/T to 0..3 and EVERY other letter to the
ambiguity code 4 (unlike the reference path, reads keep their Ns: the
SMEM stage treats code 4 as a seeding barrier and BSW scores it as a
mismatch, exactly as bwa maps non-ACGT read bases to 4).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from .fasta import open_text

DEFAULT_QUAL = "I"                   # Q40, used when a writer gets no quals

_READ_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _pair in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _b in _pair:
        _READ_CODE[_b] = _i


class FastqRecord(NamedTuple):
    name: str
    seq: str
    qual: str


def encode_read(seq: str) -> np.ndarray:
    """Read string -> (L,) uint8 codes, non-ACGT -> 4 (ambiguous)."""
    return _READ_CODE[np.frombuffer(seq.encode(), dtype=np.uint8)].copy()


def read_fastq(path) -> Iterator[FastqRecord]:
    """Stream records from a (possibly gzipped) FASTQ file."""
    with open_text(path) as f:
        while True:
            head = f.readline()
            if not head:
                return
            head = head.rstrip("\n")
            if not head:                       # tolerate trailing blank lines
                continue
            if not head.startswith("@"):
                raise ValueError(f"{path}: malformed FASTQ header {head!r}")
            seq = f.readline().rstrip("\n")
            plus = f.readline().rstrip("\n")
            qual = f.readline().rstrip("\n")
            if not plus.startswith("+"):
                raise ValueError(f"{path}: missing '+' line after {head!r}")
            if len(qual) != len(seq):
                raise ValueError(
                    f"{path}: quality length {len(qual)} != sequence length "
                    f"{len(seq)} for {head!r}")
            name = head[1:].split()[0] if len(head) > 1 else ""
            if not name:
                raise ValueError(f"{path}: empty FASTQ read name")
            yield FastqRecord(name, seq, qual)


def write_fastq(path, records: Iterable[FastqRecord]) -> None:
    """Write records as FASTQ (gzip on ``.gz``)."""
    with open_text(path, "wt") as f:
        for rec in records:
            qual = rec.qual or DEFAULT_QUAL * len(rec.seq)
            f.write(f"@{rec.name}\n{rec.seq}\n+\n{qual}\n")


def pair_qname(n1: str, n2: str) -> str:
    """Shared QNAME of a read pair: strip the ``/1``/``/2`` end suffix and
    check both ends actually name the same fragment."""
    b1 = n1[:-2] if n1.endswith(("/1", "/2")) else n1
    b2 = n2[:-2] if n2.endswith(("/1", "/2")) else n2
    if b1 != b2:
        raise ValueError(f"paired FASTQ records out of sync: {n1!r} vs {n2!r}")
    return b1


def read_fastq_paired(path1, path2) -> Iterator[tuple[FastqRecord,
                                                      FastqRecord]]:
    """Lockstep iteration over synchronized R1/R2 files."""
    it1, it2 = read_fastq(path1), read_fastq(path2)
    for r1, r2 in itertools.zip_longest(it1, it2):
        if r1 is None or r2 is None:
            raise ValueError(
                f"paired FASTQ files have different record counts "
                f"({path1} vs {path2})")
        pair_qname(r1.name, r2.name)          # sync check
        yield r1, r2


def read_fastq_interleaved(path) -> Iterator[tuple[FastqRecord,
                                                   FastqRecord]]:
    """R1/R2 alternating in ONE file (bwa mem -p)."""
    it = read_fastq(path)
    for r1 in it:
        r2 = next(it, None)
        if r2 is None:
            raise ValueError(
                f"{path}: odd record count in interleaved FASTQ")
        pair_qname(r1.name, r2.name)
        yield r1, r2
