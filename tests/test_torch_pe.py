"""Paired-end ``mem`` of the port on the CPU path, SAM byte-identical to
the reference's ``pallas`` (Pallas in interpret mode) and ``batched``
engines: the PE golden (with mates that only rescue can place, telemetry
on and off), a 3-contig world, the insert-size failure fallback, the
pinned values of the pair-scoring functions, and ``stream_sam`` over
mixed SE and PE batches.  Every check is exact equality."""

import types

import numpy as np
import pytest
import torch

from repro.api import Aligner as RAligner
from repro.core.contig import build_contig_index as r_build_contig_index
from repro.io.stream import PairBatch as RPairBatch
from repro.io.stream import ReadBatch as RReadBatch
from repro.options import AlignOptions as RAlignOptions
from repro.pe import pairing as rpairing
from repro.pe.pestat import PairStat as RPairStat
from repro_torch.api import Aligner
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (make_reference, simulate_pairs,
                              simulate_pairs_multi, simulate_reference)
from repro_torch.io.stream import PairBatch, ReadBatch
from repro_torch.options import AlignOptions
from repro_torch.pe import pairing
from repro_torch.pe.pestat import PairStat

torch.set_num_threads(1)

REF_ENGINES = ("pallas", "batched")
#: the stats the PE tail adds to a batch's stats, as the reference names them
PE_KEYS = ("rescue_tasks", "rescue_bsw", "rescue_cells_useful",
           "rescue_cells_total", "n_rescued", "n_proper", "pes_failed",
           "pes_avg", "pes_std")
PE_SPANS = ("time_pe_stat_s", "time_pe_rescue_s", "time_pe_pair_s")


def ref_pairs(contigs, r1, r2, engine, telemetry=None):
    idx = r_build_contig_index(contigs)
    return RAligner(idx, RAlignOptions(engine=engine),
                    telemetry=telemetry).align_pairs(r1, r2)


@pytest.fixture(scope="module")
def pe_world():
    contigs = [("ref", make_reference(30_000, seed=5))]
    r1, r2, _ = simulate_pairs(contigs[0][1], 48, 101, insert_mean=300,
                               insert_std=30, seed=9, burst_frac=0.25)
    return contigs, r1, r2, build_contig_index(contigs)


@pytest.fixture(scope="module")
def pe_want(pe_world):
    contigs, r1, r2, _ = pe_world
    return {e: ref_pairs(contigs, r1, r2, e, telemetry=True)
            for e in REF_ENGINES}


@pytest.fixture(scope="module")
def pe_got(pe_world):
    _, r1, r2, idx = pe_world
    return {t: Aligner(idx, AlignOptions(device="cpu"),
                       telemetry=t).align_pairs(r1, r2)
            for t in (True, False)}


@pytest.mark.parametrize("engine", REF_ENGINES)
def test_pe_golden_identity(pe_want, pe_got, engine):
    got = pe_got[False]
    assert got.sam() == pe_want[engine].sam()
    assert got.paired and len(got.sam()) == 2 * 48
    st = got.stats
    # FR's stats held, and rescue placed mates through the port's BSW path
    assert st["pes_failed"][1] is False
    assert st["n_rescued"] > 0 and st["rescue_bsw"] > 0
    for k in PE_KEYS:
        assert st[k] == pe_want[engine].stats[k], k


@pytest.mark.parametrize("telemetry", [True, False])
def test_pe_golden_telemetry(pe_want, pe_got, telemetry):
    got, want = pe_got[telemetry], pe_want["pallas"]
    assert got.sam() == want.sam()
    for k in PE_KEYS:
        assert got.stats[k] == want.stats[k], k
    if telemetry:
        for k in PE_SPANS + ("rescue_planned", "rescue_window_bp",
                             "kernel_bsw_dispatches", "bsw_dispatches"):
            assert k in got.stats and k in want.stats, k
        assert got.stats["rescue_planned"] == want.stats["rescue_planned"]
        # the two packages' Hist classes differ; their fields must not
        assert (vars(got.stats["rescue_window_bp"])
                == vars(want.stats["rescue_window_bp"]))
        # every BSW block, SE stage and rescue, goes through the kernel
        # wrapper: as many dispatches as the reference's Pallas engine
        assert (got.stats["kernel_bsw_dispatches"]
                == want.stats["kernel_bsw_dispatches"]
                == got.stats["bsw_dispatches"])
        assert got.stats["occ_kernel"] == "eta32/256"
    else:
        assert not any(k in got.stats for k in PE_SPANS)


@pytest.fixture(scope="module")
def contig_world():
    contigs = simulate_reference(45_000, 3, seed=11)
    r1, r2, _ = simulate_pairs_multi(contigs, 48, 101, burst_frac=0.2)
    return contigs, r1, r2, build_contig_index(contigs)


@pytest.fixture(scope="module")
def contig_got(contig_world):
    _, r1, r2, idx = contig_world
    return Aligner(idx, device="cpu").align_pairs(r1, r2)


@pytest.mark.parametrize("engine", REF_ENGINES)
def test_pe_multicontig_identity(contig_world, contig_got, engine):
    contigs, r1, r2, _ = contig_world
    want = ref_pairs(contigs, r1, r2, engine)
    assert contig_got.sam() == want.sam()
    for k in PE_KEYS:
        assert contig_got.stats[k] == want.stats[k], k
    assert len({r.rname for r in contig_got.records()} - {"*"}) >= 2
    assert any(r.is_proper for r in contig_got.records())


def test_pestat_failure_fallback():
    """12 pairs give too few votes: every orientation fails, nothing is
    planned for rescue (no BSW block is dispatched for it) and no pair is
    proper — the same SAM as the reference."""
    ref = make_reference(20_000, seed=5)
    r1, r2, _ = simulate_pairs(ref, 12, 101, insert_mean=300, insert_std=30,
                               seed=9, burst_frac=0.25)
    contigs = [("ref", ref)]
    got = Aligner(build_contig_index(contigs), device="cpu",
                  telemetry=True).align_pairs(r1, r2)
    want = ref_pairs(contigs, r1, r2, "pallas")
    assert got.sam() == want.sam()
    st = got.stats
    assert all(st["pes_failed"]) and st["n_proper"] == 0
    assert st["rescue_tasks"] == st["rescue_bsw"] == 0
    assert st["rescue_cells_total"] == 0
    assert st.get("rescue_planned", 0) == 0
    assert not any(r.is_proper for r in got.records())


def _pes(cls, failed_fr=False):
    return [cls(), cls(low=150, high=450, avg=300.0, std=30.0,
                       failed=failed_fr), cls(),
            cls(low=10, high=900, avg=200.5, std=1.0, failed=False)]


#: (function, args); pair_score's args are (rb1, score1, rb2, score2,
#: a_match, FR failed) on a 3-contig layout of n_ref 3,000 with contig
#: starts 0, 1,000 and 2,200
PINNED = (
    [("raw_mapq", (d, a)) for d in (-7, 0, 1, 5, 33, 400) for a in (1, 2)]
    + [("blend_mapq", args) for args in (
        (200, 0, 150, 0, 0, 101, 0, 99, 0, 1),
        (200, 190, 150, 37, 60, 101, 20, 99, 80, 1),
        (180, 0, 190, 3, 0, 90, 88, 90, 0, 1),
        (250, 120, 100, 12, 17, 150, 0, 120, 40, 2, 0.25, 0.5),
        (90, 89, 95, 60, 60, 50, 0, 50, 0, 1, 1.0, 1.0))]
    + [("pair_score", args) for args in (
        (100, 90, 5600, 95, 1, False),     # FR, inside the window
        (100, 90, 5899, 95, 1, False),     # FR, distance 0
        (100, 90, 5600, 95, 1, True),      # FR failed
        (100, 90, 400, 95, 1, False),      # same strand, downstream (FF)
        (800, 90, 300, 95, 1, False),      # same strand, upstream (RR)
        (100, 90, 1100, 95, 1, False),     # across contigs
        (2300, 40, 3300, 70, 2, False),    # FR on the third contig
        (1500, 101, 4298, 101, 1, False))])


@pytest.mark.parametrize("fn, args", PINNED,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(PINNED)])
def test_pinned_pair_scoring(fn, args):
    if fn != "pair_score":
        assert (getattr(pairing, fn)(*args)
                == getattr(rpairing, fn)(*args))
        return
    rb1, s1, rb2, s2, a_match, failed = args
    idx = types.SimpleNamespace(n_ref=3000,
                                offsets=np.array([0, 1000, 2200]))
    aln = types.SimpleNamespace
    got = pairing.pair_score(aln(rb=rb1, score=s1), aln(rb=rb2, score=s2),
                             _pes(PairStat, failed), idx, a_match)
    want = rpairing.pair_score(aln(rb=rb1, score=s1), aln(rb=rb2, score=s2),
                               _pes(RPairStat, failed), idx, a_match)
    assert got == want


def test_stream_sam_mixed_se_and_pe(pe_world, tmp_path):
    contigs, r1, r2, idx = pe_world
    L = r1.shape[1]
    full = lambda n: np.full(n, L, np.int64)
    names = [f"p{i}" for i in range(16)]

    def batches(RB, PB):
        return [RB([f"s{i}" for i in range(8)], r1[:8], full(8)),
                PB(names, r1[:16], r2[:16], full(16), full(16)),
                RB([f"t{i}" for i in range(4)], r2[20:24], full(4))]
    out_t, out_r = tmp_path / "t.sam", tmp_path / "r.sam"
    st_t = Aligner(idx, device="cpu").stream_sam(
        batches(ReadBatch, PairBatch), str(out_t))
    st_r = RAligner(r_build_contig_index(contigs),
                    RAlignOptions(engine="batched")).stream_sam(
        batches(RReadBatch, RPairBatch), str(out_r))
    assert out_t.read_text() == out_r.read_text()
    for k in ("n_reads", "n_records", "n_batches"):
        assert st_t[k] == st_r[k]
    assert st_t["n_reads"] == 8 + 32 + 4
