"""The cells' index builder (``bench/frozen/index_build.py``) against the
reference's plain builder (``build_contig_index`` + ``write_bundle``):
the same arrays, dtypes, scalars, contig table and bundle bytes; the
bundle built in a child process; the bundle's key following the
builder's source; and on the card a CUDA build equal to a CPU build."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from bench.frozen import genome as G
from bench.frozen import index_build
from bench.reference.bwa_mem.contig import build_contig_index, contig_table
from bench.reference.bwa_mem.fmindex import PERSIST_ARRAYS, PERSIST_SCALARS

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _cut(config: str, total: int) -> dict:
    """``config``'s genome with its contigs scaled to ``total`` bases."""
    g = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    g = g["genome"]
    whole = sum(n for _, n in g["contigs"])
    return dict(g, contigs=[[name, max(1, n * total // whole)]
                            for name, n in g["contigs"]])


def _random(lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [(f"c{i}_{n}", rng.integers(0, 4, n, dtype=np.uint8))
            for i, n in enumerate(lengths)]


CASES = {
    "ecoli_200kbp": lambda: G.make_genome(_cut("ecoli_k12-se101", 200_000)),
    "yeast_17_contigs_200kbp": lambda: G.make_genome(
        _cut("sc_r64-pe151", 200_000)),
    "off_block_sizes": lambda: _random([1, 31, 33, 127, 129]),
    # N = 2n + 1 one below and one above a bucket of 32 and of 128
    "one_contig_15": lambda: _random([15]),
    "one_contig_16": lambda: _random([16]),
    "one_contig_63": lambda: _random([63]),
    "one_contig_64": lambda: _random([64]),
    "one_base": lambda: [("x", np.array([2], np.uint8))],
    # suffixes sharing thousands of bases: many doubling rounds
    "homopolymer_and_tandem": lambda: [
        ("polyA", np.zeros(5000, np.uint8)),
        ("tandem", np.tile(np.array([0, 1, 2, 3, 3, 2], np.uint8), 700)),
        *_random([300])],
}


def _same_bundle(got, want, tmp: pathlib.Path) -> None:
    for k in PERSIST_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        assert np.array_equal(a, b), k
    for k in PERSIST_SCALARS:
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert contig_table(got) == contig_table(want)
    G.write_bundle(tmp / "got", got)
    G.write_bundle(tmp / "want", want)
    for ext in (".ri.npz", ".ri.json"):
        assert (tmp / f"got{ext}").read_bytes() == \
            (tmp / f"want{ext}").read_bytes(), ext


@pytest.mark.parametrize("case", list(CASES))
def test_builder_equals_the_reference(case, tmp_path):
    contigs = CASES[case]()
    got = index_build.build(contigs, device="cpu")
    _same_bundle(got, build_contig_index(contigs), tmp_path)
    S = torch.from_numpy(got.seq)
    lcp = index_build.check_suffix_array(S, torch.from_numpy(got.sa))
    if case == "homopolymer_and_tandem":
        assert lcp >= 4999 and got.rounds >= 9


def test_check_finds_a_wrong_suffix_array():
    got = index_build.build(_random([500]), device="cpu")
    S, sa = torch.from_numpy(got.seq), torch.from_numpy(got.sa)
    index_build.check_suffix_array(S, sa, block=64, width=4)
    swapped = sa.clone()
    swapped[[100, 101]] = swapped[[101, 100]]
    twice = sa.clone()
    twice[5] = twice[6]
    for bad in (swapped, twice, sa[:-1]):
        with pytest.raises(AssertionError):
            index_build.check_suffix_array(S, bad)


def test_bundle_is_built_in_a_child_process(tmp_path):
    genome = _cut("sc_r64-pe151", 60_000)
    prefix = G.bundle(genome, tmp_path / "cache")
    assert prefix == tmp_path / "cache" / G.bundle_key(genome) / "ref"
    assert [p.name for p in (tmp_path / "cache").iterdir()] == \
        [prefix.parent.name]
    want = build_contig_index(G.make_genome(genome))
    G.write_bundle(tmp_path / "want", want)
    for ext in (".ri.npz", ".ri.json"):
        assert pathlib.Path(f"{prefix}{ext}").read_bytes() == \
            (tmp_path / f"want{ext}").read_bytes(), ext
    stamp = pathlib.Path(f"{prefix}.ri.npz").stat().st_mtime_ns
    assert G.bundle(genome, tmp_path / "cache") == prefix
    assert pathlib.Path(f"{prefix}.ri.npz").stat().st_mtime_ns == stamp


def test_bundle_key_follows_the_builder(tmp_path):
    assert "frozen/index_build.py" in G.BUILDER
    for rel in G.BUILDER:
        (tmp_path / "bench" / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(BENCH / rel, tmp_path / "bench" / rel)
    spec = importlib.util.spec_from_file_location(
        "bench_genome_copy", tmp_path / "bench" / "frozen" / "genome.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    genome = _cut("ecoli_k12-se101", 1000)
    assert copy.bundle_key(genome) == G.bundle_key(genome)
    with open(tmp_path / "bench" / "frozen" / "index_build.py", "a") as f:
        f.write("\n# edited\n")
    assert copy.bundle_key(genome) != G.bundle_key(genome)


@pytest.mark.card
def test_card_build_equals_cpu_and_stays_out_of_the_callers_peak(
        card, tmp_path):
    genome = _cut("ecoli_k12-se101", 2_000_000)
    contigs = G.make_genome(genome)
    got = index_build.build(contigs, device=card)
    want = index_build.build(contigs, device="cpu")
    _same_bundle(got, want, tmp_path)
    index_build.check_suffix_array(torch.from_numpy(got.seq).to(card),
                                   torch.from_numpy(got.sa).to(card))
    torch.cuda.reset_peak_memory_stats(card)
    held = torch.ones(1 << 20, device=card)
    peak = torch.cuda.max_memory_allocated(card)
    prefix = G.bundle(genome, tmp_path / "cache")
    assert torch.cuda.max_memory_allocated(card) == peak
    del held
    for ext in (".ri.npz", ".ri.json"):
        assert pathlib.Path(f"{prefix}{ext}").read_bytes() == \
            (tmp_path / f"got{ext}").read_bytes(), ext
