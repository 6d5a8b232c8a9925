"""Synthetic genome + short-read simulator (the framework's data pipeline).

BWA-MEM's benchmark datasets (Table 3) are Illumina reads of length 76-151
drawn from the human genome.  Offline we synthesize:

* a reference with *repeat structure* (segmental duplications), because SMEM
  interval sizes and chaining behaviour are driven by repeats, not by iid
  sequence;
* reads sampled from either strand with SNPs, short indels and occasional
  ambiguous bases ('N'), mimicking Illumina error/variant profiles.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_CODE[ord("N")] = 4


def encode(s: str | bytes) -> np.ndarray:
    """ASCII -> codes (0..3, N=4)."""
    if isinstance(s, str):
        s = s.encode()
    return _CODE[np.frombuffer(s, dtype=np.uint8)].copy()


def decode(codes: np.ndarray) -> str:
    out = np.where(codes < 4, _BASES[np.clip(codes, 0, 3)], ord("N"))
    return out.astype(np.uint8).tobytes().decode()


def revcomp_read(read: np.ndarray) -> np.ndarray:
    """Reverse-complement keeping ambiguous bases (N=4) as N."""
    out = (3 - read)[::-1].astype(np.uint8)
    out[out > 3] = 4
    return out


def write_fasta(path, contigs, *, width: int = 60) -> None:
    """Export simulator contigs — (name, codes) pairs from
    ``simulate_reference``, or a bare codes array — as FASTA (gzip on
    ``.gz``), so every simulated workload can be re-ingested through
    ``repro.io`` / ``repro.cli`` as a real file."""
    from ..io.fasta import write_fasta as _write
    if isinstance(contigs, np.ndarray):
        contigs = [("ref", contigs)]
    _write(path, [(name, decode(np.asarray(codes))) for name, codes in
                  contigs], width=width)


def write_fastq(path, reads, names=None, *, quals=None) -> None:
    """Export simulated reads — an (R, L) codes array or list of code
    arrays — as FASTQ (gzip on ``.gz``).

    ``names`` defaults to ``read{i}``; ``quals`` (same shape of strings)
    defaults to a constant Q40 line, since the simulators model errors
    but not quality scores."""
    from ..io.fastq import FastqRecord, write_fastq as _write

    def records():
        for i, codes in enumerate(reads):
            seq = decode(np.asarray(codes))
            name = names[i] if names is not None else f"read{i}"
            qual = quals[i] if quals is not None else "I" * len(seq)
            yield FastqRecord(str(name), seq, qual)

    _write(path, records())


def write_fastq_pair(path1, path2, reads1, reads2, names=None) -> None:
    """Export mate arrays as synchronized R1/R2 FASTQ files with the
    conventional ``/1``/``/2`` name suffixes (QNAME defaults to
    ``pair{i}``, matching the in-memory PE drivers)."""
    base = [str(names[i]) if names is not None else f"pair{i}"
            for i in range(len(reads1))]
    write_fastq(path1, reads1, names=[f"{b}/1" for b in base])
    write_fastq(path2, reads2, names=[f"{b}/2" for b in base])


def make_reference(n: int, *, seed: int = 0, repeat_frac: float = 0.3,
                   repeat_len: int = 200) -> np.ndarray:
    """Random genome with planted repeats.

    ``repeat_frac`` of the sequence is built by re-pasting earlier segments
    (with ~1% divergence), giving realistic multi-hit SMEMs.
    """
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=n, dtype=np.uint8)
    n_rep = int(n * repeat_frac / repeat_len)
    for _ in range(n_rep):
        if n <= 2 * repeat_len:
            break
        src = int(rng.integers(0, n - repeat_len))
        dst = int(rng.integers(0, n - repeat_len))
        seg = ref[src:src + repeat_len].copy()
        mut = rng.random(repeat_len) < 0.01
        seg[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        ref[dst:dst + repeat_len] = seg
    return ref


def simulate_reference(n: int, contigs: int = 1, *, seed: int = 0,
                       names: list[str] | None = None,
                       repeat_frac: float = 0.3, repeat_len: int = 200
                       ) -> list[tuple[str, np.ndarray]]:
    """Multi-contig reference: ``contigs`` chromosomes totalling ~``n``
    bases, as (name, codes) pairs ready for ``build_contig_index``.

    Contig sizes are deliberately uneven (a geometric-ish taper, like real
    karyotypes) so coordinate-translation bugs that only show up on short
    trailing contigs get exercised.  Each contig carries its own planted
    repeat structure (see ``make_reference``).
    """
    assert contigs >= 1
    if names is None:
        names = [f"chr{i + 1}" for i in range(contigs)]
    assert len(names) == contigs
    w = np.array([2.0 ** (-0.5 * i) for i in range(contigs)])
    sizes = np.maximum((n * w / w.sum()).astype(np.int64), 2 * repeat_len + 8)
    return [(names[i],
             make_reference(int(sizes[i]), seed=seed + 1000 * i,
                            repeat_frac=repeat_frac, repeat_len=repeat_len))
            for i in range(contigs)]


def _contig_assignment(rng, lengths: np.ndarray, count: int) -> np.ndarray:
    """Per-item contig id, drawn proportional to contig length."""
    p = lengths / lengths.sum()
    return rng.choice(len(lengths), size=count, p=p)


def simulate_reads_multi(ref_contigs, n_reads: int, read_len: int, *,
                         seed: int = 1, **kw):
    """Reads drawn across contigs (coverage proportional to length).

    ``ref_contigs``: (name, codes) pairs from ``simulate_reference``.
    Returns (reads, truth) where truth carries per-read ``contig`` (id
    into the contig list), ``name``, ``pos`` (contig-local), and
    ``is_rev`` — the multi-contig analogue of ``simulate_reads``.
    """
    rng = np.random.default_rng(seed)
    lengths = np.array([len(a) for _, a in ref_contigs], np.int64)
    cid = _contig_assignment(rng, lengths, n_reads)
    reads = np.empty((n_reads, read_len), np.uint8)
    pos = np.empty(n_reads, np.int64)
    is_rev = np.empty(n_reads, bool)
    for c in range(len(ref_contigs)):
        sel = np.nonzero(cid == c)[0]
        if not len(sel):
            continue
        sub, t = simulate_reads(ref_contigs[c][1], len(sel), read_len,
                                seed=seed + 7919 * (c + 1), **kw)
        reads[sel] = sub
        pos[sel] = t["pos"]
        is_rev[sel] = t["is_rev"]
    truth = {"contig": cid, "name": [ref_contigs[c][0] for c in cid],
             "pos": pos, "is_rev": is_rev}
    return reads, truth


def simulate_pairs_multi(ref_contigs, n_pairs: int, read_len: int, *,
                         seed: int = 1, **kw):
    """FR pairs drawn across contigs — each FRAGMENT stays inside one
    contig (fragments never span chromosomes), mirroring real libraries.

    Returns (reads1, reads2, truth); truth adds per-pair ``contig`` and
    ``name`` to the fields of ``simulate_pairs`` (whose positions stay
    contig-local).
    """
    rng = np.random.default_rng(seed)
    lengths = np.array([len(a) for _, a in ref_contigs], np.int64)
    cid = _contig_assignment(rng, lengths, n_pairs)
    reads1 = np.empty((n_pairs, read_len), np.uint8)
    reads2 = np.empty((n_pairs, read_len), np.uint8)
    truth = {"contig": cid, "name": [ref_contigs[c][0] for c in cid]}
    per_pair = {}
    for c in range(len(ref_contigs)):
        sel = np.nonzero(cid == c)[0]
        if not len(sel):
            continue
        r1, r2, t = simulate_pairs(ref_contigs[c][1], len(sel), read_len,
                                   seed=seed + 7919 * (c + 1), **kw)
        reads1[sel] = r1
        reads2[sel] = r2
        for k, v in t.items():
            per_pair.setdefault(k, np.zeros(n_pairs, np.asarray(v).dtype))
            per_pair[k][sel] = v
    truth.update(per_pair)
    return reads1, reads2, truth


def simulate_reads(ref: np.ndarray, n_reads: int, read_len: int, *,
                   seed: int = 1, snp_rate: float = 0.01,
                   indel_rate: float = 0.001, n_rate: float = 0.001,
                   rev_frac: float = 0.5):
    """Sample reads from both strands with SNPs / short indels / Ns.

    Returns (reads (n_reads, read_len) uint8, truth dict of arrays).
    """
    rng = np.random.default_rng(seed)
    n = len(ref)
    assert n > read_len + 8
    pos = rng.integers(0, n - read_len - 8, size=n_reads)
    is_rev = rng.random(n_reads) < rev_frac
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    for r in range(n_reads):
        frag = ref[pos[r]: pos[r] + read_len + 8].copy()
        # indels: delete or duplicate a base
        out = []
        i = 0
        while len(out) < read_len and i < len(frag):
            u = rng.random()
            if u < indel_rate:        # deletion in read
                i += 1
                continue
            if u < 2 * indel_rate:    # insertion in read (random base)
                out.append(int(rng.integers(0, 4)))
                continue
            out.append(int(frag[i]))
            i += 1
        while len(out) < read_len:
            out.append(int(rng.integers(0, 4)))
        read = np.array(out[:read_len], dtype=np.uint8)
        # SNPs
        snp = rng.random(read_len) < snp_rate
        read[snp] = (read[snp] + rng.integers(1, 4, size=int(snp.sum()))) % 4
        # ambiguous bases
        amb = rng.random(read_len) < n_rate
        read[amb] = 4
        if is_rev[r]:
            read = revcomp_read(read)
        reads[r] = read
    truth = {"pos": pos, "is_rev": is_rev}
    return reads, truth


def simulate_pairs(ref: np.ndarray, n_pairs: int, read_len: int, *,
                   insert_mean: float = 300.0, insert_std: float = 30.0,
                   seed: int = 1, snp_rate: float = 0.01,
                   n_rate: float = 0.001, flip_frac: float = 0.5,
                   burst_frac: float = 0.0, burst_period: int = 12):
    """FR paired-end simulator (Illumina-style innies).

    A fragment of length ``isize ~ N(insert_mean, insert_std)`` is sampled
    from the forward strand; read1 is its left end read forward and read2
    its right end read reverse-complemented (FR orientation).  With
    probability ``flip_frac`` the fragment is sequenced from the other
    strand (read1 becomes the reverse-complemented right end), which keeps
    the orientation FR but exercises both flag layouts.

    ``burst_frac`` pairs get a *rescue-only* mate: read2's source carries a
    SNP every ``burst_period`` bases, so no exact seed reaches the default
    SMEM ``min_seed_len`` (19) and the end-to-end pipeline leaves the mate
    unmapped — only the insert-size-window mate rescue can place it.

    Returns (reads1, reads2, truth) where truth holds per-pair arrays:
    ``pos`` (fragment start), ``isize``, ``pos1``/``pos2`` (forward-strand
    starts per end), ``rev1``/``rev2`` (strand per end), ``burst``.
    """
    rng = np.random.default_rng(seed)
    n = len(ref)
    L = read_len
    isize = np.round(rng.normal(insert_mean, insert_std,
                                n_pairs)).astype(np.int64)
    isize = np.clip(isize, L + 2, n - 2)
    pos = rng.integers(0, n - isize)
    flip = rng.random(n_pairs) < flip_frac
    burst = rng.random(n_pairs) < burst_frac
    reads1 = np.empty((n_pairs, L), np.uint8)
    reads2 = np.empty((n_pairs, L), np.uint8)
    pos1 = np.where(flip, pos + isize - L, pos)
    pos2 = np.where(flip, pos, pos + isize - L)
    rev1, rev2 = flip, ~flip

    def _mutate(read):
        snp = rng.random(L) < snp_rate
        read[snp] = (read[snp] + rng.integers(1, 4, size=int(snp.sum()))) % 4
        amb = rng.random(L) < n_rate
        read[amb] = 4
        return read

    for i in range(n_pairs):
        r1 = _mutate(ref[pos1[i]:pos1[i] + L].copy())
        r2 = ref[pos2[i]:pos2[i] + L].copy()
        if burst[i]:
            at = np.arange(burst_period // 2, L, burst_period)
            r2[at] = (r2[at] + rng.integers(1, 4, size=len(at))) % 4
        else:
            r2 = _mutate(r2)
        reads1[i] = revcomp_read(r1) if rev1[i] else r1
        reads2[i] = revcomp_read(r2) if rev2[i] else r2
    truth = {"pos": pos, "isize": isize, "pos1": pos1, "pos2": pos2,
             "rev1": rev1, "rev2": rev2, "burst": burst}
    return reads1, reads2, truth
