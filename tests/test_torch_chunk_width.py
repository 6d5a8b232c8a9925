"""The port's SAM does not depend on the ``-K`` chunk's width, and the
collector's counter of a traced stream.

Single-end reads drawn by the benchmark's read simulator from a ~50-kbp
genome of the benchmark's kind are mapped by ``Aligner.stream_sam`` on
the CPU over one chunk that holds every read (bwa's own batch is wider
than a chunk of any test) and over chunks of ~10,000 bases; both streams
equal, byte for byte, the benchmark's plain reference
(``bench.reference.bwa_mem.align_se``) on the same reads.  The JAX
package's ``stream_sam`` maps the first ``SMALL`` reads at both widths,
and its SAM equals the port's byte for byte.  Single-end SAM has no
per-chunk state (no insert-size stats), so the width may change nothing.

The collector's counter (``obs.GcClock``) is registered by a traced
stream alone, for the stream's length: ``time_gc_s``, ``gc_collections``
and ``gc_full`` in the summary.
"""

from __future__ import annotations

import gc
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.api import Aligner as RAligner
from repro.io.stream import open_batches as r_open_batches
from repro.options import AlignOptions as RAlignOptions
from repro_torch import obs
from repro_torch.api import Aligner
from repro_torch.io.stream import open_batches
from repro_torch.options import AlignOptions

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.frozen.genome import bundle, make_genome  # noqa: E402
from bench.frozen.reads import Simulator, Traffic, fastq  # noqa: E402
from bench.reference import bwa_mem as ref  # noqa: E402

torch.set_num_threads(1)

CONFIG = json.loads((ROOT / "bench/configs/ecoli_k12-se101.json").read_text())
FLAGS = CONFIG["options"]
GENOME = dict(CONFIG["genome"], seed=50_021, contigs=[["c1", 50_000]])
READ_LEN = 101
N_READS = 3_000
#: the narrow streams: thirds of the reads, in chunks of ~10,000 bases
PARTS = 3
NARROW_BASES = 10_000
#: reads of the JAX package's streams and of the collector's tests
#: (three narrow chunks)
SMALL = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The bundle, the reads as one FASTQ file, as ``PARTS`` files of
    consecutive reads and as a file of the first ``SMALL``, and the
    reference's SAM records of every read."""
    tmp = tmp_path_factory.mktemp("chunk_width")
    prefix = bundle(GENOME, tmp / "index")
    traffic = Traffic.from_json(
        json.loads((ROOT / "bench/traffic/wgsim.json").read_text()))
    sim = Simulator(make_genome(GENOME), traffic, 2 ** 31 + 11,
                    read_len=READ_LEN, paired=False)
    names, reads = sim.reads(np.arange(N_READS))
    whole = tmp / "all.fq"
    whole.write_bytes(fastq(names, reads))
    parts = []
    for k, rows in enumerate(np.array_split(np.arange(N_READS), PARTS)):
        path = tmp / f"part{k}.fq"
        path.write_bytes(fastq([names[r] for r in rows], reads[rows]))
        parts.append((path, set(names[r] for r in rows)))
    small = tmp / "small.fq"
    small.write_bytes(fastq(names[:SMALL], reads[:SMALL]))
    idx = ref.load_index(prefix)
    return {"prefix": prefix, "whole": whole, "parts": parts, "small": small,
            "want": ref.align_se(idx, reads, names, FLAGS, "cpu"),
            "header": ref.sam_header(idx)}


def _aligner(world, telemetry=None) -> Aligner:
    return Aligner.from_bundle(world["prefix"],
                               AlignOptions.from_flags(FLAGS), device="cpu",
                               telemetry=telemetry)


def _stream(aligner, path, chunk_bases) -> tuple[list, list, dict]:
    sink = io.StringIO()
    summary = aligner.stream_sam(open_batches(str(path),
                                              chunk_bases=chunk_bases), sink)
    lines = sink.getvalue().splitlines()
    return ([ln for ln in lines if ln.startswith("@")],
            [ln for ln in lines if not ln.startswith("@")], summary)


def _records_of(lines, names) -> list:
    return [ln for ln in lines if ln.split("\t", 1)[0] in names]


def test_one_chunk_of_every_read_equals_the_reference(world):
    head, body, summary = _stream(_aligner(world), world["whole"],
                                  N_READS * READ_LEN)
    assert summary["n_batches"] == 1 and summary["n_reads"] == N_READS
    assert body == world["want"] and len(body) >= N_READS
    assert head == world["header"]


@pytest.mark.parametrize("part", range(PARTS))
def test_narrow_chunks_equal_the_reference(world, part):
    """Each third of the reads in chunks of ~10,000 bases (100 reads):
    its records equal the reference's, and so the one wide chunk's."""
    path, names = world["parts"][part]
    head, body, summary = _stream(_aligner(world), path, NARROW_BASES)
    per = -(-NARROW_BASES // READ_LEN)
    assert summary["n_batches"] == -(-len(names) // per) > 1
    assert body == _records_of(world["want"], names)
    assert head == world["header"]


@pytest.mark.parametrize("chunk_bases", [SMALL * READ_LEN, NARROW_BASES],
                         ids=["one_chunk", "narrow"])
def test_jax_package_equals_the_port(world, chunk_bases):
    """The first ``SMALL`` reads through both packages' ``stream_sam``
    over the same chunks: the same SAM, byte for byte."""
    head, body, summary = _stream(_aligner(world), world["small"],
                                  chunk_bases)
    sink = io.StringIO()
    rsummary = RAligner.from_bundle(
        world["prefix"], RAlignOptions.from_flags(FLAGS)).stream_sam(
        r_open_batches(str(world["small"]), chunk_bases=chunk_bases), sink)
    lines = sink.getvalue().splitlines()
    assert rsummary["n_batches"] == summary["n_batches"]
    assert len(body) >= SMALL
    assert body == [ln for ln in lines if not ln.startswith("@")]
    assert head == [ln for ln in lines if ln.startswith("@")]


def _collecting(batches, seen: list):
    """``batches``, with a full collection and a look at ``gc.callbacks``
    before each chunk is handed on."""
    for b in batches:
        gc.collect()
        seen.append(len(gc.callbacks))
        yield b


def test_traced_stream_counts_the_collector(world):
    aligner = _aligner(world, obs.Telemetry(trace=True))
    before = list(gc.callbacks)
    seen: list = []
    summary = aligner.stream_sam(
        _collecting(open_batches(str(world["small"]),
                                 chunk_bases=NARROW_BASES), seen), io.StringIO())
    stats = summary["stats"]
    assert seen and all(n == len(before) + 1 for n in seen)
    assert gc.callbacks == before
    assert stats["gc_full"] >= len(seen)
    assert stats["gc_collections"] >= stats["gc_full"]
    assert stats["time_gc_s"] >= 0.0


@pytest.mark.parametrize("telemetry", [None, "metrics"])
def test_untraced_stream_registers_nothing(world, telemetry):
    aligner = _aligner(world, obs.Telemetry() if telemetry else None)
    before = list(gc.callbacks)
    seen: list = []
    summary = aligner.stream_sam(
        _collecting(open_batches(str(world["small"]),
                                 chunk_bases=NARROW_BASES), seen), io.StringIO())
    assert seen and all(n == len(before) for n in seen)
    assert gc.callbacks == before
    assert not {"time_gc_s", "gc_collections", "gc_full"} & set(
        summary["stats"])


def test_hook_is_gone_after_a_stream_that_fails(world):
    aligner = _aligner(world, obs.Telemetry(trace=True))
    before = list(gc.callbacks)

    def failing():
        yield next(open_batches(str(world["small"]),
                                chunk_bases=NARROW_BASES))
        raise RuntimeError("the read stream broke")

    with pytest.raises(RuntimeError, match="broke"):
        aligner.stream_sam(failing(), io.StringIO())
    assert gc.callbacks == before


def test_gc_clock_sums_into_the_registry():
    reg = obs.MetricsRegistry()
    clock = obs.GcClock()
    with clock.running(reg):
        assert clock._hook in gc.callbacks
        gc.collect(0)
        gc.collect()
    assert clock._hook not in gc.callbacks
    snap = reg.snapshot()
    assert snap["gc_collections"] == clock.collections >= 2
    assert snap["gc_full"] == clock.full >= 1
    assert snap["time_gc_s"] == clock.seconds >= 0.0
