"""The port's ``baseline`` engine (the original BWA-MEM organisation: read
by read, the scalar SMEM oracle, the compressed-SA LF walk, the scalar
``ksw_extend``) against the reference's, on the CPU.  Every check is
exact equality:

* ``smem1``, ``collect_smems`` and ``brute_smems`` on seeded reads with
  ambiguous bases, and the port's oracle against its own lockstep batch;
* ``FMIndex.sa_lookup_compressed`` and ``sal_compressed`` (both occ
  layouts): values and steps against the reference's and against the
  uncompressed SA; ``seeds_from_intervals(compressed=True)``;
* ``wasted_cell_stats``;
* ``run_rescues_scalar``: rescued alignments field by field and stats;
* the SE golden, PE golden and 3-contig SAM of the port's ``baseline``
  against the reference's ``baseline`` and the port's ``cuda`` engine;
  the baseline touches no kernel path;
* ``cli mem --engine baseline --device cpu`` against ``repro.cli mem
  --engine baseline``, single-end and paired.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro import cli as rcli
from repro import pe as rpe
from repro.api import Aligner as RAligner
from repro.core import bsw as rbsw
from repro.core import fmindex as rfm
from repro.core import pipeline as rpipeline
from repro.core import sal as rsal
from repro.core import smem as rsm
from repro.core.contig import build_contig_index as r_build_contig_index
from repro.options import AlignOptions as RAlignOptions
from repro_torch import cli as tcli
from repro_torch import pe
from repro_torch.api import Aligner
from repro_torch.core import bsw as tbsw
from repro_torch.core import fmindex as tfm
from repro_torch.core import pipeline
from repro_torch.core import sal as tsal
from repro_torch.core import smem as tsm
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (make_reference, simulate_pairs, simulate_reads,
                              simulate_reads_multi, simulate_reference,
                              write_fasta, write_fastq)
from repro_torch.kernels import bsw as kbsw
from repro_torch.kernels import diagseed as kdiagseed
from repro_torch.kernels import engine as kengine
from repro_torch.kernels import galign as kgalign
from repro_torch.kernels.fmocc import OccConfig
from repro_torch.options import ENGINE_BASELINE, AlignOptions

torch.set_num_threads(1)

BASELINE = AlignOptions(engine=ENGINE_BASELINE, device="cpu")
CUDA_ON_CPU = AlignOptions(device="cpu")
RBASELINE = RAlignOptions(engine="baseline")


# ------------------------------- SMEM -------------------------------

@pytest.fixture(scope="module")
def smem_world():
    ref = make_reference(12000, seed=5)
    reads, _ = simulate_reads(ref, 10, 101, seed=2)
    rng = np.random.default_rng(4)
    random = rng.integers(0, 4, size=(2, 101)).astype(reads.dtype)
    reads = np.concatenate([reads, random])
    reads[0, 10:14] = 4            # a run of ambiguous bases
    reads[1, 0] = 4                # leading N
    reads[2, -1] = 4               # trailing N
    reads[3, ::17] = 4             # scattered Ns
    reads[4, rng.integers(0, 101, 6)] = 4
    return rfm.build_index(ref), tfm.build_index(ref), reads


def test_smem1_and_seed_strategy1_equal_reference(smem_world):
    ridx, tidx, reads = smem_world
    for q in reads:
        for x in range(len(q)):
            assert tsm.smem1(tidx, q, x, 1) == rsm.smem1(ridx, q, x, 1)
            assert tsm.smem1(tidx, q, x, 3) == rsm.smem1(ridx, q, x, 3)
            assert tsm.seed_strategy1(tidx, q, x, 19, 20) == \
                rsm.seed_strategy1(ridx, q, x, 19, 20)
    assert tidx.backward_ext(5, 7, 0, 4) == ridx.backward_ext(5, 7, 0, 4)
    assert tidx.forward_ext(5, 7, 3, 4) == ridx.forward_ext(5, 7, 3, 4)


def test_collect_and_brute_smems_equal_reference(smem_world):
    ridx, tidx, reads = smem_world
    opt, ropt = tsm.MemOptions(), rsm.MemOptions()
    got = [tsm.collect_smems(tidx, q, opt) for q in reads]
    assert got == [rsm.collect_smems(ridx, q, ropt) for q in reads]
    assert sum(map(len, got)) > len(reads)
    for q in reads[:6]:
        assert tsm.brute_smems(tidx, q) == rsm.brute_smems(ridx, q)
    # the oracle and the port's lockstep batch agree, both occ layouts
    lens = np.full(len(reads), reads.shape[1], np.int64)
    for layout in ("eta32", "eta128"):
        assert tsm.collect_smems_batch(
            tidx, reads, lens, opt,
            occ=OccConfig(layout, 256, "cpu")) == got


# -------------------------------- SAL --------------------------------

@pytest.fixture(scope="module")
def sal_rows(smem_world):
    ridx, _, _ = smem_world
    rng = np.random.default_rng(8)
    rows = rng.integers(0, ridx.N, 3000)
    # the sentinel row, sampled rows and their neighbours
    extra = [0, 1, ridx.primary, ridx.primary + 1, ridx.N - 1, 32, 33, 31]
    return np.concatenate([rows, extra]).astype(np.int64)


def test_sa_lookup_compressed_equals_reference(smem_world, sal_rows):
    ridx, tidx, _ = smem_world
    got = [tidx.sa_lookup_compressed(int(i)) for i in sal_rows]
    assert got == [ridx.sa_lookup_compressed(int(i)) for i in sal_rows]
    assert [v for v, _ in got] == tidx.sa[sal_rows].tolist()
    # the walk stops at the next row of the sampled rows (every 32nd),
    # or at the sentinel's: a sampled row takes no step
    steps = [t for _, t in got]
    assert min(steps) == 0 and max(steps) > tfm.SA_SAMPLE


@pytest.mark.parametrize("eta32", [True, False])
def test_sal_compressed_equals_reference(smem_world, sal_rows, eta32):
    ridx, tidx, _ = smem_world
    fm = tidx.device("cpu")
    rows = torch.from_numpy(sal_rows)
    vals, steps = tsal.sal_compressed(fm, rows, occ_eta32=eta32)
    assert vals.dtype == steps.dtype == torch.int32
    assert vals.device == steps.device == fm.sa.device
    rvals, rsteps = rsal.sal_compressed(ridx.device(),
                                        np.asarray(sal_rows, np.int32),
                                        occ_eta32=eta32)
    assert vals.tolist() == np.asarray(rvals).tolist()
    assert steps.tolist() == np.asarray(rsteps).tolist()
    assert torch.equal(vals, tsal.sal_direct(fm, rows))
    assert steps.tolist() == [tidx.sa_lookup_compressed(int(i))[1]
                              for i in sal_rows]
    empty = tsal.sal_compressed(fm, rows[:0], occ_eta32=eta32)
    assert [t.shape for t in empty] == [(0,), (0,)]


@pytest.mark.parametrize("eta32", [True, False])
def test_seeds_from_compressed_sal_equal_direct(smem_world, eta32):
    ridx, tidx, reads = smem_world
    mems = [tsm.collect_smems(tidx, q, tsm.MemOptions()) for q in reads]
    got = tsal.seeds_from_intervals(tidx, mems, 3, device="cpu",
                                    compressed=True, occ_eta32=eta32)
    assert got == tsal.seeds_from_intervals(tidx, mems, 3, device="cpu")
    assert got == rsal.seeds_from_intervals(ridx, mems, 3, compressed=True,
                                            occ_eta32=eta32)


# -------------------------------- BSW --------------------------------

@pytest.mark.parametrize("block", [128, 7])
def test_wasted_cell_stats_equal_reference(block):
    rng = np.random.default_rng(block)
    qlens = rng.integers(1, 150, 300)
    tlens = rng.integers(1, 250, 300)
    for order in (np.arange(300), tbsw.sort_tasks_by_length(qlens, tlens)):
        got = tbsw.wasted_cell_stats(qlens, tlens, order, block=block)
        assert got == rbsw.wasted_cell_stats(qlens, tlens, order,
                                             block=block)
        assert 0 < got[0] <= got[1]
    sorted_ = tbsw.sort_tasks_by_length(qlens, tlens)
    assert tbsw.wasted_cell_stats(qlens, tlens, sorted_, block)[1] < \
        tbsw.wasted_cell_stats(qlens, tlens, np.arange(300), block)[1]


# ------------------------------- engines -------------------------------

N_PAIRS = 48


@pytest.fixture(scope="module")
def se_world():
    contigs = [("ref", make_reference(12000, seed=7))]
    reads, _ = simulate_reads(contigs[0][1], 8, 101, seed=3)
    return contigs, reads, build_contig_index(contigs)


@pytest.fixture(scope="module")
def contig_world():
    contigs = simulate_reference(30000, 3, seed=11)
    reads, _ = simulate_reads_multi(contigs, 10, 101, seed=13)
    return contigs, reads, build_contig_index(contigs)


@pytest.fixture(scope="module")
def pe_world():
    contigs = [("ref", make_reference(30_000, seed=5))]
    r1, r2, _ = simulate_pairs(contigs[0][1], N_PAIRS, 101, insert_mean=300,
                               insert_std=30, seed=9, burst_frac=0.25)
    return (contigs, r1, r2, build_contig_index(contigs),
            r_build_contig_index(contigs))


def fields(alns_per_read):
    return [[dataclasses.asdict(a) for a in alns] for alns in alns_per_read]


def test_run_rescues_scalar_equals_reference(pe_world):
    _, r1, r2, idx, ridx = pe_world
    both = np.concatenate([r1, r2])
    opt = pipeline.PipelineOptions(device="cpu")
    res, st = pipeline.run_se_baseline(idx, both, opt)
    rres, rst = rpipeline.run_se_baseline(ridx, both)
    assert fields(res) == fields(rres) and dict(st) == dict(rst)
    t1, t2 = res[:N_PAIRS], res[N_PAIRS:]
    q1, q2 = rres[:N_PAIRS], rres[N_PAIRS:]
    pes = pe.estimate_pestat(t1, t2, idx)
    rpes = rpe.estimate_pestat(q1, q2, ridx)
    tasks = pe.plan_rescues((t1, t2), (r1, r2), pes, idx, pe.PEOptions())
    rtasks = rpe.plan_rescues((q1, q2), (r1, r2), rpes, ridx,
                              rpe.PEOptions())
    assert tasks, "the burst mates must give rescue work"
    outs, st = pe.run_rescues_scalar(tasks, idx, opt.bsw)
    routs, rst = rpe.run_rescues_scalar(rtasks, ridx, opt.bsw)
    assert fields(outs) == fields(routs)
    assert st == rst and st["rescue_bsw"] > 0
    # the scalar and the batched drivers rescue alike
    bouts, bst = pe.run_rescues_batched(copy.deepcopy(tasks), idx, opt.bsw,
                                        device=opt.device)
    assert fields(bouts) == fields(outs)
    assert bst["rescue_bsw"] == st["rescue_bsw"]


def test_se_golden_identity(se_world):
    contigs, reads, idx = se_world
    got = Aligner(idx, BASELINE).align(reads)
    want = RAligner(r_build_contig_index(contigs), RBASELINE).align(reads)
    assert got.sam() == want.sam()
    assert got.sam() == Aligner(idx, CUDA_ON_CPU).align(reads).sam()
    assert got.n_mapped > 0
    for k in ("sa_lookups", "bsw_tasks"):
        assert got.stats[k] == want.stats[k] > 0


def test_multicontig_identity(contig_world):
    contigs, reads, idx = contig_world
    got = Aligner(idx, BASELINE).align(reads).sam()
    assert got == RAligner(r_build_contig_index(contigs),
                           RBASELINE).align(reads).sam()
    assert got == Aligner(idx, CUDA_ON_CPU).align(reads).sam()


def test_pe_golden_identity(pe_world):
    _, r1, r2, idx, ridx = pe_world
    got = Aligner(idx, BASELINE).align_pairs(r1, r2)
    want = RAligner(ridx, RBASELINE).align_pairs(r1, r2)
    assert got.sam() == want.sam()
    assert got.sam() == Aligner(idx, CUDA_ON_CPU).align_pairs(r1, r2).sam()
    assert got.stats["n_rescued"] > 0
    for k in ("rescue_tasks", "rescue_bsw", "n_rescued", "n_proper",
              "pes_failed", "pes_avg", "pes_std", "sa_lookups"):
        assert got.stats[k] == want.stats[k], k


def test_pe_multicontig_identity():
    from repro_torch.data import simulate_pairs_multi
    contigs = simulate_reference(30000, 3, seed=21)
    r1, r2, _ = simulate_pairs_multi(contigs, 12, 101, insert_mean=300,
                                     insert_std=30, seed=23)
    got = Aligner(build_contig_index(contigs), BASELINE).align_pairs(r1, r2)
    assert got.sam() == RAligner(r_build_contig_index(contigs),
                                 RBASELINE).align_pairs(r1, r2).sam()


def test_baseline_touches_no_kernel_path(se_world, pe_world, monkeypatch):
    """The baseline runs on the host whatever the device: it asks for no
    occ configuration, no kernel entry and no device view of the
    index, single-end or paired."""
    _, reads, idx = se_world
    _, r1, r2, pidx, _ = pe_world
    want = Aligner(idx, BASELINE).align(reads[:3]).sam()
    want_pe = Aligner(pidx, BASELINE).align_pairs(r1[:8], r2[:8]).sam()

    def refuse(*a, **k):
        raise AssertionError("the baseline reached a kernel path")
    monkeypatch.setattr(kengine, "attach_occ_config", refuse)
    monkeypatch.setattr(tsm, "ext_round", refuse)
    monkeypatch.setattr(kbsw, "bsw_extend_kernel", refuse)
    monkeypatch.setattr(kgalign, "global_align_batch", refuse)
    monkeypatch.setattr(kdiagseed, "diag_seed_batch", refuse)
    monkeypatch.setattr(tfm.FMIndex, "device", refuse)
    assert Aligner(idx, BASELINE).align(reads[:3]).sam() == want
    assert Aligner(pidx, BASELINE).align_pairs(r1[:8], r2[:8]).sam() == \
        want_pe


@pytest.fixture(scope="module")
def files(tmp_path_factory, contig_world, pe_world):
    contigs, reads, _ = contig_world
    d = tmp_path_factory.mktemp("torch_baseline_cli")
    fa, fq = str(d / "ref.fa"), str(d / "reads.fq")
    write_fasta(fa, contigs)
    write_fastq(fq, reads)
    pcontigs, r1, r2, _, _ = pe_world
    pfa = str(d / "pref.fa")
    write_fasta(pfa, pcontigs)
    fq1, fq2 = str(d / "r1.fq"), str(d / "r2.fq")
    write_fastq(fq1, r1[:16], [f"p{i}" for i in range(16)])
    write_fastq(fq2, r2[:16], [f"p{i}" for i in range(16)])
    return d, (fa, fq), (pfa, fq1, fq2)


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_cli_identity_with_reference_cli(files, kind):
    d, se, pe_files = files
    args = list(se if kind == "se" else pe_files)
    out_t, out_r, out_c = (str(d / f"{kind}_{n}.sam")
                           for n in ("t", "r", "c"))
    assert tcli.main(["mem", *args, "-o", out_t, "--engine", "baseline",
                      "--device", "cpu", "--no-pg", "-b", "4"]) == 0
    assert rcli.main(["mem", *args, "-o", out_r, "--engine", "baseline",
                      "--no-pg", "-b", "4"]) == 0
    assert tcli.main(["mem", *args, "-o", out_c, "--device", "cpu",
                      "--no-pg", "-b", "4"]) == 0
    with open(out_t) as t, open(out_r) as r, open(out_c) as c:
        got = t.read()
        assert got == r.read() and got == c.read()
    assert got.count("\n") > 10
