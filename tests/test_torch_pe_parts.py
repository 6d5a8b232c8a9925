"""The paired-end parts of the port against the reference's, on the same
single-end results: insert-size estimation and its JSON form across the
two packages, mate rescue (planned tasks, rescued alignments field by
field, stats, the merge), and frozen insert-size stats through
``estimate_pe_stats`` and ``Aligner(pe_stats=...)``.  Every check is
exact equality."""

import copy
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro import pe as rpe
from repro.api import Aligner as RAligner
from repro.core import pipeline as rpipeline
from repro.core.contig import build_contig_index as r_build_contig_index
from repro.options import AlignOptions as RAlignOptions
from repro_torch import obs, pe
from repro_torch.api import Aligner
from repro_torch.core import pipeline
from repro_torch.core.contig import build_contig_index
from repro_torch.kernels import bsw as kbsw
from repro_torch.kernels.diagseed import diag_seed_batch
from repro_torch.data import make_reference, simulate_pairs

torch.set_num_threads(1)

N_PAIRS = 48


@pytest.fixture(scope="module")
def world():
    contigs = [("ref", make_reference(30_000, seed=5))]
    r1, r2, _ = simulate_pairs(contigs[0][1], N_PAIRS, 101, insert_mean=300,
                               insert_std=30, seed=9, burst_frac=0.25)
    return (contigs, r1, r2, build_contig_index(contigs),
            r_build_contig_index(contigs))


@pytest.fixture(scope="module")
def se_results(world):
    """Both ends' SE results, each package on its own index: (port res1,
    res2, reference res1, res2)."""
    _, r1, r2, idx, ridx = world
    both = np.concatenate([r1, r2])
    res, _ = pipeline.run_se_batched(idx, both,
                                     pipeline.PipelineOptions(device="cpu"))
    rres, _ = rpipeline.run_se_batched(ridx, both)
    return res[:N_PAIRS], res[N_PAIRS:], rres[:N_PAIRS], rres[N_PAIRS:]


def fields(alns_per_read):
    return [[dataclasses.asdict(a) for a in alns] for alns in alns_per_read]


def test_pestat_estimates_and_json_across_packages(world, se_results):
    _, _, _, idx, ridx = world
    t1, t2, q1, q2 = se_results
    got = pe.estimate_pestat(t1, t2, idx)
    want = rpe.estimate_pestat(q1, q2, ridx)
    assert not got[1].failed
    js_got, js_want = pe.pestat_to_jsonable(got), rpe.pestat_to_jsonable(want)
    assert json.dumps(js_got) == json.dumps(js_want)
    # a manifest written by either package loads in the other, exactly
    back = pe.pestat_from_jsonable(json.loads(json.dumps(js_want)))
    assert back == got
    rback = rpe.pestat_from_jsonable(json.loads(json.dumps(js_got)))
    assert rback == want


def test_rescue_matches_reference(world, se_results):
    _, r1, r2, idx, ridx = world
    t1, t2, q1, q2 = copy.deepcopy(se_results)
    opt = pipeline.PipelineOptions(device="cpu")
    ropt = rpipeline.PipelineOptions()
    peopt, rpeopt = pe.PEOptions(), rpe.PEOptions()
    pes = pe.estimate_pestat(t1, t2, idx)
    rpes = rpe.estimate_pestat(q1, q2, ridx)
    tasks = pe.plan_rescues((t1, t2), (r1, r2), pes, idx, peopt)
    rtasks = rpe.plan_rescues((q1, q2), (r1, r2), rpes, ridx, rpeopt)
    assert tasks, "the burst mates must give rescue work"
    assert ([(t.pair_id, t.end, t.r, t.chain.seeds) for t in tasks]
            == [(t.pair_id, t.end, t.r, t.chain.seeds) for t in rtasks])
    assert all(np.array_equal(a.query, b.query)
               for a, b in zip(tasks, rtasks))
    outs, st = pe.run_rescues_batched(tasks, idx, opt.bsw, device=opt.device,
                                      block=opt.bsw_block)
    routs, rst = rpe.run_rescues_batched(rtasks, ridx, ropt.bsw,
                                         block=ropt.bsw_block,
                                         batch_fn=rpipeline.bsw_batch_fn(ropt))
    assert fields(outs) == fields(routs)
    assert dict(st) == dict(rst) and st["rescue_bsw"] > 0
    n = pe.merge_rescues((t1, t2), tasks, outs, idx, opt.bsw,
                         opt.mem.min_seed_len, peopt)
    rn = rpe.merge_rescues((q1, q2), rtasks, routs, ridx, ropt.bsw,
                           ropt.mem.min_seed_len, rpeopt)
    assert n == rn > 0
    assert fields(t1) == fields(q1) and fields(t2) == fields(q2)
    assert any(a.rescued for alns in t2 for a in alns)


@pytest.mark.parametrize("batched", [False, True])
def test_plan_rescues_seed_fn_matches_reference(world, se_results, batched):
    """The plan with the default host ``seed_fn`` and with the batched one
    (``kernels.diagseed.diag_seed_batch``, its plain version on the CPU):
    the reference's
    tasks, seeds and queries, and its ``rescue_window_bp`` histogram."""
    _, r1, r2, idx, ridx = world
    t1, t2, q1, q2 = se_results
    pes = pe.estimate_pestat(t1, t2, idx)
    rpes = rpe.estimate_pestat(q1, q2, ridx)
    kw = dict(seed_fn=functools.partial(diag_seed_batch, device="cpu")
              ) if batched else {}
    reg, rreg = obs.MetricsRegistry(), robs.MetricsRegistry()
    with obs.activate(reg):
        tasks = pe.plan_rescues((t1, t2), (r1, r2), pes, idx, pe.PEOptions(),
                                **kw)
    with robs.activate(rreg):
        rtasks = rpe.plan_rescues((q1, q2), (r1, r2), rpes, ridx,
                                  rpe.PEOptions())
    assert tasks
    assert ([(t.pair_id, t.end, t.r, t.chain.seeds) for t in tasks]
            == [(t.pair_id, t.end, t.r, t.chain.seeds) for t in rtasks])
    assert all(np.array_equal(a.query, b.query)
               for a, b in zip(tasks, rtasks))
    snap, rsnap = reg.snapshot(), rreg.snapshot()
    assert vars(snap["rescue_window_bp"]) == vars(rsnap["rescue_window_bp"])
    assert snap["rescue_planned"] == rsnap["rescue_planned"] == len(tasks)
    # every candidate window is scanned, and some hold no anchor seed
    assert snap["rescue_windows"] > len(tasks)


def test_rescue_without_tasks_dispatches_nothing(world, monkeypatch):
    _, _, _, idx, _ = world
    calls = []
    monkeypatch.setattr(kbsw, "bsw_extend_kernel",
                        lambda *a, **k: calls.append(a))
    outs, st = pe.run_rescues_batched(
        [], idx, pipeline.PipelineOptions().bsw, device="cpu")
    assert outs == [] and calls == []
    assert st == dict(rescue_tasks=0, rescue_bsw=0, rescue_cells_useful=0,
                      rescue_cells_total=0)


@pytest.fixture(scope="module")
def frozen(world):
    """Insert-size stats estimated from the first 32 pairs by each
    package."""
    contigs, r1, r2, idx, ridx = world
    lead = (r1[:32], r2[:32])
    got = Aligner(idx, device="cpu").estimate_pe_stats(*lead)
    want = RAligner(ridx, RAlignOptions(engine="batched")
                    ).estimate_pe_stats(*lead)
    return got, want


def test_estimate_pe_stats_matches_reference(frozen):
    got, want = frozen
    assert pe.pestat_to_jsonable(got) == rpe.pestat_to_jsonable(want)
    assert not got[1].failed


def test_frozen_stats_identity(world, frozen):
    """The last 16 pairs under the stats frozen from the first 32: the
    port's estimate and the reference's (loaded through the port's JSON
    reader) give the reference's SAM, which differs from what the 16
    pairs alone estimate."""
    contigs, r1, r2, idx, ridx = world
    got, want = frozen
    tail = (r1[32:], r2[32:])
    ref_sam = RAligner(ridx, RAlignOptions(engine="batched"),
                       pe_stats=want).align_pairs(*tail).sam()
    loaded = pe.pestat_from_jsonable(rpe.pestat_to_jsonable(want))
    for stats in (got, loaded):
        res = Aligner(idx, device="cpu", pe_stats=stats).align_pairs(*tail)
        assert res.sam() == ref_sam
        assert res.stats["pes_avg"] == [s.avg for s in got]
    own = Aligner(idx, device="cpu").align_pairs(*tail)
    assert own.stats["pes_avg"] != [s.avg for s in got]
