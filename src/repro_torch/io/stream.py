"""Chunked streaming batch reader for the stage-major pipeline.

The batched engines behind ``repro.api.Aligner`` want rectangular
(B, L) uint8 batches — the whole point of the paper's reorganisation is
running each stage over a big batch.  This module turns a FASTQ stream
into exactly that shape (``open_batches`` is the one-call entry point;
feed its iterator straight to ``Aligner.stream_sam``):

* fixed-size batches (the last one ragged), sequences length-padded with
  the ambiguity code 4, true lengths carried alongside (trailing pad
  bases seed nothing and soft-clip out, so equal-length Illumina input —
  the common case — is bit-exact, and mixed lengths degrade gracefully);
* synchronized R1/R2 pair batches from split or interleaved FASTQ, with
  the shared pair QNAME extracted per pair;
* a deterministic ``shard=(i, n)`` filter that keeps every record (pair)
  whose GLOBAL ordinal is ``i (mod n)`` — the same partition no matter
  the batch size, which is what lets ``repro.dist`` workers each stream
  their slice of one FASTQ with no coordination beyond rank/world-size
  (see ``repro.dist.api.read_shard``);
* bwa ``-K``-style FIXED-BASE chunking (``chunk_bases``): a batch is
  flushed once its accumulated true base count reaches the threshold,
  so the batch decomposition depends only on the input file and the
  threshold — NOT on batch_size, worker count or scheduling.  That is
  exactly why production pipelines pin ``bwa mem -K`` (nf-core runs
  ``-K 100000000`` so output is thread-count-invariant): per-batch
  decisions (PE insert-size estimates) land on the same batches no
  matter how the work is spread.  ``plan_chunks`` pre-scans the same
  decomposition without packing anything, and ``chunk_range=(lo, hi)``
  streams only chunks ``lo..hi-1`` — the contiguous-chunk shard
  assignment of the resilient ``repro.dist.run`` driver (and its
  resume path, which bumps ``lo`` past completed chunks).

Like bwa (which processes reads in ~10 Mbp chunks and estimates the
insert-size distribution per chunk), the PE statistics downstream are
per-batch: pick ``batch_size`` (or ``chunk_bases``) large enough for
stable estimates — or freeze a bootstrap estimate via
``Aligner.estimate_pe_stats``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .. import obs
from .fastq import (encode_read, pair_qname, read_fastq,
                    read_fastq_interleaved, read_fastq_paired)

PAD_CODE = 4                        # ambiguity code: seeds nothing, clips out


def _note_batch(n_reads: int, cells: int, base_count: int) -> None:
    """Telemetry for one packed batch: fill/pad-waste accounting (the
    batched engines compute over the padded rectangle, so wasted pad
    fraction is lost device work — same accounting as BSW Table 8).
    No-ops unless an ``obs`` scope is active (``Aligner.stream_sam``
    activates one around its ``next()`` pulls)."""
    obs.count("io_batches")
    obs.count("io_reads", n_reads)
    obs.count("io_bases", base_count)
    if cells:
        obs.observe("io_pad_frac", (cells - base_count) / cells,
                    edges=obs.RATIO_EDGES)


@dataclasses.dataclass
class ReadBatch:
    names: list
    reads: np.ndarray               # (B, Lmax) uint8, padded with PAD_CODE
    lens: np.ndarray                # (B,) int64 true lengths

    def __len__(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class PairBatch:
    names: list                     # shared per-pair QNAMEs
    reads1: np.ndarray              # (B, Lmax) uint8
    reads2: np.ndarray
    lens1: np.ndarray
    lens2: np.ndarray

    def __len__(self) -> int:
        return len(self.names)


def check_shard(shard) -> tuple[int, int] | None:
    if shard is None:
        return None
    i, n = int(shard[0]), int(shard[1])
    if not 0 <= i < n:
        raise ValueError(f"bad shard {shard}: need 0 <= i < n")
    return (i, n)


def _sharded(it, shard):
    """Keep items whose global ordinal == i (mod n)."""
    if shard is None:
        yield from it
        return
    i, n = shard
    for ordinal, item in enumerate(it):
        if ordinal % n == i:
            yield item


def check_chunking(chunk_bases, chunk_range):
    if chunk_bases is None:
        if chunk_range is not None:
            raise ValueError("chunk_range needs chunk_bases")
        return None, None
    chunk_bases = int(chunk_bases)
    if chunk_bases < 1:
        raise ValueError("chunk_bases must be >= 1")
    if chunk_range is not None:
        lo, hi = int(chunk_range[0]), int(chunk_range[1])
        if not 0 <= lo <= hi:
            raise ValueError(f"bad chunk_range {chunk_range}: "
                             f"need 0 <= lo <= hi")
        chunk_range = (lo, hi)
    return chunk_bases, chunk_range


def _chunked(it, chunk_bases, nbases, chunk_range=None):
    """Group a record stream into fixed-base chunks (the ONE flush rule
    shared by the streamers and ``plan_chunks``): a chunk closes as soon
    as its accumulated ``nbases(item)`` reaches ``chunk_bases``.  With
    ``chunk_range=(lo, hi)`` only chunks ``lo..hi-1`` are yielded (the
    rest are still counted, so chunk identity is global)."""
    lo, hi = (0, None) if chunk_range is None else chunk_range
    buf: list = []
    bases = 0
    ordinal = 0

    def keep():
        return ordinal >= lo and (hi is None or ordinal < hi)

    for item in it:
        if hi is not None and ordinal >= hi and not buf:
            return                      # past the window: stop reading
        buf.append(item)
        bases += nbases(item)
        if bases >= chunk_bases:
            if keep():
                yield ordinal, buf
            ordinal += 1
            buf, bases = [], 0
    if buf and keep():
        yield ordinal, buf


def plan_chunks(path1, path2=None, *, chunk_bases: int,
                interleaved: bool = False) -> list[tuple[int, int]]:
    """Pre-scan the fixed-base chunk decomposition of a FASTQ (pair).

    Returns one ``(n_reads, n_bases)`` entry per chunk — for pairs,
    reads and bases count BOTH ends, matching the streamers' flush rule
    exactly (same ``_chunked`` generator), so ``plan_chunks`` followed by
    ``open_batches(chunk_bases=..., chunk_range=(i, i+1))`` reproduces
    chunk ``i`` byte-for-byte.  This is the planning pass of the
    resilient multi-shard driver (``repro.dist.run``): the chunk list is
    frozen into the job manifest and chunks are dealt to shards as
    contiguous ranges.
    """
    chunk_bases, _ = check_chunking(chunk_bases, None)
    if interleaved and path2 is not None:
        raise ValueError("interleaved input takes a single FASTQ")
    if path2 is not None or interleaved:
        pairs = (read_fastq_interleaved(path1) if interleaved
                 else read_fastq_paired(path1, path2))
        return [(2 * len(chunk),
                 sum(len(r1.seq) + len(r2.seq) for r1, r2 in chunk))
                for _, chunk in _chunked(
                    pairs, chunk_bases,
                    lambda p: len(p[0].seq) + len(p[1].seq))]
    return [(len(chunk), sum(len(r.seq) for r in chunk))
            for _, chunk in _chunked(read_fastq(path1), chunk_bases,
                                     lambda r: len(r.seq))]


def pack_reads(seqs: list[str], width: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad a list of read strings to one (B, width) array
    (width defaults to the batch max length).  Returns (reads, lens) —
    the true lengths that ``Aligner.align`` uses to mask the padding."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = int(lens.max(initial=1)) if width is None else width
    out = np.full((len(seqs), L), PAD_CODE, dtype=np.uint8)
    for r, s in enumerate(seqs):
        out[r, :len(s)] = encode_read(s)
    return out, lens


def _pack_se(names: list, seqs: list) -> ReadBatch:
    reads, lens = pack_reads(seqs)
    _note_batch(len(names), reads.size, int(lens.sum()))
    return ReadBatch(list(names), reads, lens)


def _pack_pe(names: list, s1: list, s2: list) -> PairBatch:
    # ONE width across both ends: the PE driver stacks R1 and R2 into
    # a single (2B, L) batch, so per-side maxima must agree
    w = max(max(map(len, s1)), max(map(len, s2)))
    reads1, lens1 = pack_reads(s1, w)
    reads2, lens2 = pack_reads(s2, w)
    _note_batch(2 * len(names), reads1.size + reads2.size,
                int(lens1.sum() + lens2.sum()))
    return PairBatch(list(names), reads1, reads2, lens1, lens2)


def stream_batches(path, batch_size: int = 512, *, shard=None,
                   chunk_bases: int | None = None,
                   chunk_range=None) -> Iterator[ReadBatch]:
    """Single-end FASTQ -> fixed-size padded ``ReadBatch``es.

    With ``chunk_bases`` set, batches are fixed-BASE chunks instead
    (bwa ``-K``; ``batch_size`` is ignored) and ``chunk_range=(lo, hi)``
    keeps only that contiguous chunk window.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    shard = check_shard(shard)
    chunk_bases, chunk_range = check_chunking(chunk_bases, chunk_range)
    records = _sharded(read_fastq(path), shard)
    if chunk_bases is not None:
        for _, chunk in _chunked(records, chunk_bases,
                                 lambda r: len(r.seq), chunk_range):
            yield _pack_se([r.name for r in chunk], [r.seq for r in chunk])
        return
    names: list[str] = []
    seqs: list[str] = []
    for rec in records:
        names.append(rec.name)
        seqs.append(rec.seq)
        if len(names) == batch_size:
            yield _pack_se(names, seqs)
            names, seqs = [], []
    if names:
        yield _pack_se(names, seqs)


def stream_pair_batches(path1, path2=None, batch_size: int = 512, *,
                        interleaved: bool = False, shard=None,
                        chunk_bases: int | None = None,
                        chunk_range=None) -> Iterator[PairBatch]:
    """Paired FASTQ (split R1/R2 files, or one interleaved file) ->
    synchronized ``PairBatch``es; ``shard`` partitions by PAIR ordinal so
    mates never land on different workers.  ``chunk_bases`` switches to
    fixed-base chunk batches counting BOTH ends (pairs are never split
    across chunks); ``chunk_range`` as in :func:`stream_batches`."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if interleaved and path2 is not None:
        raise ValueError("interleaved input takes a single FASTQ")
    shard = check_shard(shard)
    chunk_bases, chunk_range = check_chunking(chunk_bases, chunk_range)
    pairs = _sharded(read_fastq_interleaved(path1) if interleaved
                     else read_fastq_paired(path1, path2), shard)
    if chunk_bases is not None:
        for _, chunk in _chunked(
                pairs, chunk_bases,
                lambda p: len(p[0].seq) + len(p[1].seq), chunk_range):
            yield _pack_pe([pair_qname(r1.name, r2.name)
                            for r1, r2 in chunk],
                           [r1.seq for r1, _ in chunk],
                           [r2.seq for _, r2 in chunk])
        return
    names: list[str] = []
    s1: list[str] = []
    s2: list[str] = []
    for r1, r2 in pairs:
        names.append(pair_qname(r1.name, r2.name))
        s1.append(r1.seq)
        s2.append(r2.seq)
        if len(names) == batch_size:
            yield _pack_pe(names, s1, s2)
            names, s1, s2 = [], [], []
    if names:
        yield _pack_pe(names, s1, s2)


def open_batches(path1, path2=None, *, batch_size: int = 512,
                 interleaved: bool = False, shard=None,
                 chunk_bases: int | None = None,
                 chunk_range=None) -> Iterator[ReadBatch | PairBatch]:
    """Unified entry point: one FASTQ -> ``ReadBatch``es, two FASTQs (or
    one interleaved) -> ``PairBatch``es.  The returned iterator plugs
    straight into ``repro.api.Aligner.stream_sam``, which dispatches on
    the batch type.  ``chunk_bases``/``chunk_range`` select bwa
    ``-K``-style fixed-base chunk batches (see module docstring)."""
    kw = dict(shard=shard, chunk_bases=chunk_bases, chunk_range=chunk_range)
    if path2 is not None or interleaved:
        return stream_pair_batches(path1, path2, batch_size,
                                   interleaved=interleaved, **kw)
    return stream_batches(path1, batch_size, **kw)
