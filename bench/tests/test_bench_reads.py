"""The read simulator: the same seed gives the same reads, and its rates
are wgsim's on a fixed seed."""

from __future__ import annotations

import numpy as np
import pytest

from bench.frozen.genome import make_genome
from bench.frozen.reads import BLOCK, Simulator, Traffic, fastq, mutate

GENOME = {"seed": 11, "contigs": [["a", 60000], ["b", 40000]],
          "repeat_frac": 0.3, "repeat_len": 200}
WGSIM = Traffic(mutation_rate=0.001, indel_frac=0.15, indel_extend=0.3,
                error_rate=0.02)


def test_genome_is_the_seeds():
    a, b = make_genome(GENOME), make_genome(GENOME)
    assert [n for n, _ in a] == ["a", "b"]
    assert [len(c) for _, c in a] == [60000, 40000]
    assert all((x[1] == y[1]).all() for x, y in zip(a, b))
    assert not (a[0][1] == make_genome(dict(GENOME, seed=12))[0][1]).all()


@pytest.mark.parametrize("paired", [False, True])
def test_same_seed_same_reads(paired):
    g = make_genome(GENOME)
    big = 2 ** 31 + 12345
    s1 = Simulator(g, WGSIM, big, read_len=101, paired=paired)
    s2 = Simulator(g, WGSIM, big, read_len=101, paired=paired)
    s3 = Simulator(g, WGSIM, big + 1, read_len=101, paired=paired)
    for x, y in zip(s1.block(3)[1:], s2.block(3)[1:]):
        assert (x == y).all()
    assert not (s1.block(3)[1] == s3.block(3)[1]).all()
    # a read made again alone equals the one of its block
    idx = np.array([3 * BLOCK + 5, 7])
    again = s1.reads(idx)
    assert again[0] == [s1.block(3)[0][5], s1.block(0)[0][7]]
    assert (again[1][0] == s1.block(3)[1][5]).all()


def test_error_rate():
    g = [("a", np.zeros(50000, np.uint8))]     # all A: errors are non-0
    sim = Simulator(g, WGSIM, 5, read_len=101, paired=False,
                    haplotype=False)
    names, reads = sim.block(0)
    # reverse-complemented reads are all T (3): an error is any other base
    fwd = (reads == 0).sum(axis=1) > (reads == 3).sum(axis=1)
    err = np.where(fwd[:, None], reads != 0, reads != 3).mean()
    assert abs(err - 0.02) < 0.002
    assert 0.45 < fwd.mean() < 0.55
    assert names[:2] == ["r0", "r1"]


def test_mutation_model():
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, 400000, dtype=np.uint8)
    t = Traffic(mutation_rate=0.01, indel_frac=0.15, indel_extend=0.3,
                error_rate=0.0)
    hap = mutate(np.random.default_rng(2), seq, t)
    # indels change the length by about nothing on average (ins = del)
    assert abs(len(hap) - len(seq)) < 0.002 * len(seq)
    # substitutions only: 0.85% of the bases differ
    sub = Traffic(mutation_rate=0.01, indel_frac=0.0, indel_extend=0.3,
                  error_rate=0.0)
    h2 = mutate(np.random.default_rng(2), seq, sub)
    assert len(h2) == len(seq)
    assert abs((h2 != seq).mean() - 0.01) < 0.001


def test_pairs_are_fr_fragments():
    seq = np.random.default_rng(3).integers(0, 4, 200000, dtype=np.uint8)
    t = Traffic(mutation_rate=0.0, indel_frac=0.15, indel_extend=0.3,
                error_rate=0.0)
    sim = Simulator([("a", seq)], t, 9, read_len=151, paired=True)
    names, r1, r2 = sim.block(0)
    assert names[0] == "p0" and r1.shape == r2.shape == (BLOCK, 151)
    at = {seq[i:i + 151].tobytes(): i for i in range(len(seq) - 150)}
    fwd = lambda r: at.get(r.tobytes())                  # noqa: E731
    rev = lambda r: at.get((3 - r[::-1]).tobytes())      # noqa: E731
    spans, firsts = [], 0
    for a, b in zip(r1[:600], r2[:600]):
        # FR: read 1 forward and read 2 reverse, or the other way round
        x, y = (fwd(a), rev(b)) if fwd(a) is not None else (rev(a), fwd(b))
        assert x is not None and y is not None
        firsts += fwd(a) is not None and x < y
        spans.append(abs(y - x) + 151)
    assert abs(np.mean(spans) - 500) < 10 and 40 < np.std(spans) < 60
    # read 1 comes from the left end on about half of the pairs
    assert 0.42 < firsts / 600 < 0.58


def test_fastq_records():
    reads = np.array([[0, 1, 2, 3], [3, 3, 0, 0]], np.uint8)
    out = fastq(["p0", "p1"], reads, "/1").decode()
    assert out == "@p0/1\nACGT\n+\nIIII\n@p1/1\nTTAA\n+\nIIII\n"


@pytest.mark.parametrize("name", ["tiny-se.wgsim", "tiny-pe.wgsim"])
def test_files_of_reads_give_the_chunks_of_one_stream(checkout, tmp_path,
                                                      name):
    """The producer's files, read one after another, give the chunks that
    one FASTQ stream of the same reads gives, and it keeps ``LEAD`` files
    written ahead, no more."""
    import itertools
    import time

    from repro_torch.io.stream import open_batches

    from bench import harness
    cell = harness.load_cell(name, checkout)
    n_chunks = 2 * harness.SEGMENT_CHUNKS + 1
    reads = harness.Reads(cell, 2 ** 33 + 1, checkout)
    try:
        reads.ahead()
        time.sleep(0.5)
        assert len(list(reads.dir.glob("seg*.0.fq"))) == harness.LEAD
        got = list(itertools.islice(reads.batches(cell.chunk_bases),
                                    n_chunks))
    finally:
        reads.close()
    assert not reads.dir.exists()
    sim = Simulator(make_genome(cell.config["genome"]),
                    Traffic.from_json(cell.traffic), 2 ** 33 + 1,
                    read_len=cell.read_len, paired=cell.paired)
    made = sim.reads(np.arange(n_chunks * cell.chunk_items))
    paths = []
    for end, r in enumerate(made[1:]):
        paths.append(tmp_path / f"{end}.fq")
        paths[-1].write_bytes(fastq(made[0], r, f"/{end + 1}"
                                    if cell.paired else ""))
    want = list(open_batches(*map(str, paths), chunk_bases=cell.chunk_bases))
    assert len(want) == n_chunks
    assert [len(b) for b in got] == [cell.chunk_items] * n_chunks
    for g, w in zip(got, want):
        assert g.names == w.names
        for k in ("reads1", "reads2") if cell.paired else ("reads",):
            assert (getattr(g, k) == getattr(w, k)).all()


@pytest.mark.parametrize("paired", [False, True])
def test_segments_across_blocks(paired):
    """Segments longer than a block and not aligned to one hold the
    simulator's reads in order."""
    from bench.producer import segment_bytes
    sim = Simulator(make_genome(GENOME), WGSIM, 17, read_len=101,
                    paired=paired)
    n = BLOCK + 1000
    blocks: dict = {}
    got = [segment_bytes(sim, j, n, blocks) for j in range(3)]
    assert set(blocks) == {(3 * n - 1) // BLOCK}
    made = sim.reads(np.arange(3 * n))
    for end, r in enumerate(made[1:]):
        want = fastq(made[0], r, f"/{end + 1}" if paired else "")
        assert b"".join(g[end] for g in got) == want
