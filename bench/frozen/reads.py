"""The read simulator: wgsim's model, vectorised.

A run's reads come from one haplotype of the configuration's genome,
mutated from the run's seed as wgsim mutates it (haploid): each base is
mutated with ``mutation_rate``; a mutation is an indel with
``indel_frac`` (insertion or deletion alike, one base and one more with
``indel_extend`` each time), else a substitution.  Reads are drawn from
the haplotype, contig by length, from either strand; every base then
carries a sequencing error with ``error_rate`` (a substitution).  Pairs
are FR: a fragment of N(``frag_mean``, ``frag_std``) bases, read 1 from
one end and read 2 from the other, reverse-complemented, the two ends
swapped on half of the pairs.

Reads are made in blocks of ``BLOCK`` (reads, or pairs) from the seed
and the block's number, so any read can be made again alone.  Read ``i``
is named ``r<i>``, pair ``i`` ``p<i>/1`` and ``p<i>/2``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 2048
ASCII = np.frombuffer(b"ACGTN", np.uint8)
QUAL = "I"


@dataclasses.dataclass(frozen=True)
class Traffic:
    mutation_rate: float
    indel_frac: float
    indel_extend: float
    error_rate: float
    frag_mean: float = 500.0
    frag_std: float = 50.0

    @classmethod
    def from_json(cls, d: dict) -> "Traffic":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def seed_words(seed: int, *more: int) -> list[int]:
    """A seed of any size as words of a ``SeedSequence``."""
    return [int(seed) & (2 ** 64 - 1), *more]


def mutate(rng, seq: np.ndarray, t: Traffic) -> np.ndarray:
    """One haplotype of ``seq`` under wgsim's mutation model."""
    n = len(seq)
    site = np.flatnonzero(rng.random(n) < t.mutation_rate)
    indel = rng.random(len(site)) < t.indel_frac
    out = seq.copy()
    sub = site[~indel]
    out[sub] = (out[sub] + rng.integers(1, 4, len(sub))) % 4
    isite = site[indel]
    ins = rng.random(len(isite)) < 0.5
    length = rng.geometric(1.0 - t.indel_extend, len(isite))
    # deletions: [site, site + length) drop out
    cover = np.zeros(n + 1, np.int64)
    np.add.at(cover, isite[~ins], 1)
    np.add.at(cover, np.minimum(isite[~ins] + length[~ins], n), -1)
    keep = np.cumsum(cover[:n]) == 0
    # insertions: ``length`` random bases after a kept base
    extra = np.zeros(n, np.int64)
    np.add.at(extra, isite[ins], length[ins])
    extra[~keep] = 0
    width = keep.astype(np.int64) + extra
    hap = rng.integers(0, 4, int(width.sum()), dtype=np.uint8)
    hap[(np.cumsum(width) - width)[keep]] = out[keep]
    return hap


class Simulator:
    """Reads of one run: the haplotype of ``contigs`` for ``seed`` (the
    contigs themselves without ``haplotype``), and its blocks of reads
    (``paired`` or not, ``read_len`` bases)."""

    def __init__(self, contigs, traffic: Traffic, seed: int, *,
                 read_len: int, paired: bool, haplotype: bool = True):
        self.t = traffic
        self.seed = seed
        self.L = int(read_len)
        self.paired = paired
        rng = np.random.default_rng(seed_words(seed, 0))
        haps = [mutate(rng, codes, traffic) if haplotype else codes
                for _, codes in contigs]
        self.hap = np.concatenate(haps)
        self.lens = np.array([len(h) for h in haps], np.int64)
        self.offs = np.concatenate([[0], np.cumsum(self.lens)[:-1]])

    def _revcomp(self, reads: np.ndarray, rows: np.ndarray) -> None:
        reads[rows] = 3 - reads[rows, ::-1]

    def _errors(self, rng, reads: np.ndarray) -> None:
        hit = rng.random(reads.shape) < self.t.error_rate
        reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4

    def block(self, b: int):
        """Block ``b``: (names, reads) of ``BLOCK`` reads, or (names,
        reads1, reads2) of ``BLOCK`` pairs; reads are (n, L) uint8."""
        rng = np.random.default_rng(seed_words(self.seed, 1, b))
        n, L = BLOCK, self.L
        cid = rng.choice(len(self.lens), n, p=self.lens / self.lens.sum())
        span = np.full(n, L, np.int64)
        if self.paired:
            frag = np.round(rng.normal(self.t.frag_mean, self.t.frag_std, n))
            span = np.clip(frag.astype(np.int64), L, self.lens[cid] - 1)
        start = self.offs[cid] + (rng.random(n) * (self.lens[cid] - span + 1)
                                  ).astype(np.int64)
        cols = np.arange(L)
        first = b * BLOCK
        if not self.paired:
            reads = self.hap[start[:, None] + cols]
            self._revcomp(reads, rng.random(n) < 0.5)
            self._errors(rng, reads)
            return [f"r{first + i}" for i in range(n)], reads
        left = self.hap[start[:, None] + cols]
        right = self.hap[(start + span - L)[:, None] + cols]
        flip = rng.random(n) < 0.5
        r1 = np.where(flip[:, None], right, left)
        r2 = np.where(flip[:, None], left, right)
        self._errors(rng, r1)
        self._errors(rng, r2)
        # read 1 is reverse-complemented where it comes from the right end
        self._revcomp(r1, flip)
        self._revcomp(r2, ~flip)
        return [f"p{first + i}" for i in range(n)], r1, r2

    def reads(self, index: np.ndarray):
        """The reads (or pairs) of global numbers ``index``, as ``block``
        returns them."""
        index = np.asarray(index, np.int64)
        parts = {}
        for b in np.unique(index // BLOCK):
            parts[int(b)] = self.block(int(b))
        names = [parts[int(i // BLOCK)][0][int(i % BLOCK)] for i in index]
        arrays = [np.stack([parts[int(i // BLOCK)][k][int(i % BLOCK)]
                            for i in index])
                  for k in range(1, 3 if self.paired else 2)]
        return (names, *arrays)


def fastq(names: list, reads: np.ndarray, suffix: str = "") -> bytes:
    """FASTQ records of ``reads`` (codes 0..3), one per name."""
    L = reads.shape[1]
    seqs = ASCII[reads].tobytes().decode()
    qual = QUAL * L
    return "".join(f"@{name}{suffix}\n{seqs[i * L:(i + 1) * L]}\n+\n{qual}\n"
                   for i, name in enumerate(names)).encode()
