"""The BSW stage's planner (``core.pipeline.BatchedBSWExecutor``): its
four waves, planned over whole-chunk arrays, against the scalar replay
(``bsw_immediate``) on SE and mate-rescue chunks; its vectorised pieces
(``chain_windows``, ``max_gaps``, ``adjusted_bands``) against their
scalar forms; and one bsw launch a non-empty wave, with the task count
of the reference's block-by-block planner.  The oracles are the
reference package's (``repro.core.pipeline``, ``repro.core.bsw``), on
its own index of the same contigs.  Every check is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import pipeline as rpipeline
from repro.core.bsw import BSWParams as RParams
from repro.core.bsw import adjusted_band as r_adjusted_band
from repro.core.bsw import bsw_extend as r_extend
from repro.core.chain import Chain as RChain
from repro.core.contig import build_contig_index as r_build_contig_index
from repro_torch import obs, pe
from repro_torch.core import pipeline
from repro_torch.core import sal as sal_mod
from repro_torch.core import smem as smem_mod
from repro_torch.core.bsw import BSWParams, adjusted_bands
from repro_torch.core.chain import Chain, chain_seeds, filter_chains
from repro_torch.core.contig import build_contig_index, contig_edges
from repro_torch.core.pipeline import (BatchedBSWExecutor, chain2aln,
                                       chain_windows, max_gaps)
from repro_torch.data import (make_reference, simulate_pairs, simulate_reads,
                              simulate_reads_multi, simulate_reference)
from repro_torch.kernels import bsw as kbsw
from repro_torch.kernels.fmocc.ops import DEFAULT_CANDIDATE, OccConfig

torch.set_num_threads(1)

P = BSWParams()


def r_params(p: BSWParams) -> RParams:
    """The reference's BSWParams of ``p``."""
    return RParams(**dataclasses.asdict(p))


def r_chain(c: Chain) -> RChain:
    """The reference's Chain of ``c``."""
    return RChain(seeds=list(c.seeds), weight=c.weight)


def r_scalar_batch(qs, ts, h0s, p, ws=None, qmax=None, tmax=None):
    """A ``batch_fn`` for the reference's planner: its scalar
    ``bsw_extend``, task by task."""
    return [r_extend(q, t, h0, p, w) for q, t, h0, w in zip(qs, ts, h0s, ws)]


def se_jobs(idx, reads):
    """The BSW stage's jobs of ``reads``, as ``run_se_batched`` makes
    them: SMEM, SAL and chaining on the CPU."""
    opt = pipeline.PipelineOptions(device="cpu")
    lens = np.full(len(reads), reads.shape[1], np.int64)
    mems = smem_mod.collect_smems_batch(
        idx, reads, lens, opt.mem, occ=OccConfig(*DEFAULT_CANDIDATE, "cpu"))
    seeds, _ = sal_mod.seeds_from_intervals(idx, mems, opt.mem.max_occ,
                                            device="cpu")
    edges = contig_edges(idx)
    jobs = []
    for r in range(len(reads)):
        chains = filter_chains(chain_seeds(
            [(rb, qb, ln) for (rb, qb, ln, _) in seeds[r]], idx.n_ref,
            opt.chain, edges), opt.chain)
        jobs.extend(((r, ci), c, reads[r], idx) for ci, c in enumerate(chains))
    return jobs


def chunk(kind: str, seed: int):
    """(idx, the reference's index of the same contigs, jobs) of a random
    chunk: SE reads on one contig (with 3% indels: "se_indel") or on
    three, or the mate-rescue tasks of a PE chunk with burst mates."""
    if kind in ("se_single", "se_indel"):
        ref = make_reference(20_000, seed=seed)
        contigs = [("ref", ref)]
        idx = build_contig_index(contigs)
        indel = 0.03 if kind == "se_indel" else 0.001
        return idx, r_build_contig_index(contigs), se_jobs(
            idx, simulate_reads(ref, 24, 101, seed=seed,
                                indel_rate=indel)[0])
    if kind == "se_multi":
        contigs = simulate_reference(30_000, 3, seed=seed)
        idx = build_contig_index(contigs)
        reads, _ = simulate_reads_multi(contigs, 24, 101, seed=seed)
        return idx, r_build_contig_index(contigs), se_jobs(idx, reads)
    ref = make_reference(30_000, seed=seed)
    contigs = [("ref", ref)]
    idx = build_contig_index(contigs)
    r1, r2, _ = simulate_pairs(ref, 32, 101, insert_mean=300, insert_std=30,
                               seed=seed, burst_frac=0.25)
    res, _ = pipeline.run_se_batched(idx, np.concatenate([r1, r2]),
                                     pipeline.PipelineOptions(device="cpu"))
    ends = (res[:32], res[32:])
    tasks = pe.plan_rescues(ends, (r1, r2), pe.estimate_pestat(*ends, idx),
                            idx, pe.PEOptions())
    return idx, r_build_contig_index(contigs), [
        (ti, t.chain, t.query, idx) for ti, t in enumerate(tasks)]


@pytest.mark.parametrize("kind,seed,w", [
    ("se_single", 1, 100), ("se_single", 2, 100), ("se_multi", 3, 100),
    ("pe_rescue", 4, 100), ("se_indel", 5, 100), ("se_indel", 6, 4)])
def test_planner_matches_scalar_replay(kind, seed, w):
    """Each job's ``chain2aln`` replayed through ``executor(jid)`` gives
    the alignments of the reference's scalar replay (its ``chain2aln``
    through ``_bsw_immediate``), asks for the same tasks, and has each
    answered with the reference's ``bsw_extend`` of the same (q, t, h0,
    w).  The plan holds exactly the (side, seed, round) tasks of the
    reference's planner, with its results.  Indels under a band of 4
    make the band-doubled retries (waves L1 and R1) common."""
    idx, ridx, jobs = chunk(kind, seed)
    assert np.array_equal(np.asarray(ridx.seq), idx.seq)
    assert len(jobs) >= 8
    p = BSWParams(w=w)
    rp = r_params(p)
    ex = BatchedBSWExecutor(p, device="cpu")
    ex.plan_and_run(jobs)
    rex = rpipeline.BatchedBSWExecutor(rp, batch_fn=r_scalar_batch)
    rex.plan_and_run([(jid, r_chain(c), q, ridx) for jid, c, q, _ in jobs])
    assert ex.stats["tasks"] == len(rex.table)
    asked = {0: 0, 1: 0}
    for jid, chain, query, _ in jobs:
        scalar, seen, want = {}, set(), rpipeline._bsw_immediate(rp)

        def immediate(side, k, rnd, q, t, h0, w):
            r = want(side, k, rnd, q, t, h0, w)
            scalar[side, k, rnd] = (q, t, h0, w, dataclasses.astuple(r))
            return r
        fn = ex.executor(jid)

        def planned(side, k, rnd, q, t, h0, w):
            q0, t0, h00, w0, r = scalar[side, k, rnd]
            assert (np.array_equal(q, q0) and np.array_equal(t, t0)
                    and (h0, w) == (h00, w0))
            got = fn(side, k, rnd, q, t, h0, w)
            assert dataclasses.astuple(got) == r
            seen.add((side, k, rnd))
            return got
        ralns = rpipeline.chain2aln(r_chain(chain), query, ridx, rp,
                                    immediate)
        alns = chain2aln(chain, query, idx, p, planned)
        assert seen == set(scalar)
        assert ([dataclasses.astuple(a) for a in alns]
                == [dataclasses.astuple(a) for a in ralns])
        for _, _, rnd in scalar:
            asked[rnd] += 1
        # the reference's plan, task by task; a task it did not run raises
        for side in "LR":
            for k in range(len(chain.seeds)):
                for rnd in (0, 1):
                    r = rex.table.get((jid, side, k, rnd))
                    if r is None:
                        with pytest.raises(KeyError):
                            fn(side, k, rnd, None, None, 0, 0)
                    else:
                        assert (dataclasses.astuple(fn(side, k, rnd, None,
                                                       None, 0, 0))
                                == dataclasses.astuple(r))
        for key in (("L", len(chain.seeds), 0), ("R", -1, 0), ("R", 0, 2)):
            with pytest.raises(KeyError):
                fn(*key, None, None, 0, 0)
    assert asked[0] >= 10 and (w > 4 or asked[1] >= 3)


def _seeds_in_block(rng, lo, hi, lq):
    """1-4 seeds of one chain inside the block [lo, hi), the first two
    on its edges when the draw says so."""
    out = []
    for j in range(int(rng.integers(1, 5))):
        ln = int(rng.integers(19, min(lq, 60) + 1))
        qb = int(rng.integers(0, lq - ln + 1))
        edge = int(rng.integers(0, 3))
        if j == 0 and edge == 1:
            rb = lo                               # on the block's start
        elif j == 0 and edge == 2:
            rb = hi - ln                          # ends on the block's end
        else:
            rb = int(rng.integers(lo, hi - ln + 1))
        out.append((rb, qb, ln))
    return out


@pytest.mark.parametrize("n_contigs,p", [
    (1, P), (3, P), (1, BSWParams(w=5)),
    (3, BSWParams(a=2, b=3, o_del=4, e_del=2, o_ins=5, e_ins=3, w=40))])
def test_chain_windows_match_scalar(n_contigs, p):
    """``chain_windows`` equals the reference's ``_chain_rmax`` chain by
    chain, with seeds on contig edges and on the strand boundary
    (``l_pac``)."""
    contigs = simulate_reference(12_000, n_contigs, seed=n_contigs)
    idx = build_contig_index(contigs)
    ridx = r_build_contig_index(contigs)
    edges = contig_edges(idx)
    rng = np.random.default_rng(7 + n_contigs)
    chains, lqs = [], []
    for c in range(300):
        b = int(rng.integers(0, len(edges) - 1))
        lq = int(rng.choice([40, 101, 151]))
        chains.append(Chain(seeds=_seeds_in_block(rng, int(edges[b]),
                                                  int(edges[b + 1]), lq)))
        lqs.append(lq)
    l_pac = idx.n_ref
    for lq, seeds in ((101, [(l_pac, 0, 30)]), (101, [(l_pac - 30, 71, 30)]),
                      (151, [(l_pac - 40, 0, 40), (l_pac - 100, 50, 25)]),
                      (40, [(0, 10, 30)]), (40, [(2 * l_pac - 30, 5, 30)])):
        chains.append(Chain(seeds=seeds))
        lqs.append(lq)
    counts = np.array([len(c.seeds) for c in chains])
    rb, qb, ln = np.array([s for c in chains for s in c.seeds]).T
    got = chain_windows(rb, qb, ln, np.repeat(lqs, counts),
                        np.cumsum(counts) - counts, edges, l_pac, p, p.w)
    want = [rpipeline._chain_rmax(r_chain(c), lq, ridx, r_params(p), p.w)
            for c, lq in zip(chains, lqs)]
    assert list(zip(*(a.tolist() for a in got))) == want


@pytest.mark.parametrize("p", [
    P, BSWParams(end_bonus=0), BSWParams(o_ins=3, e_ins=2, o_del=9, e_del=4),
    BSWParams(a=2, b=5, o_del=5, e_del=3, o_ins=7, e_ins=1, end_bonus=11)])
def test_vector_bands_and_gaps_match_scalar(p):
    """``adjusted_bands`` equals the reference's ``adjusted_band`` and
    ``max_gaps`` its ``cal_max_gap`` over a grid of lengths x widths."""
    qlens = np.arange(0, 401)
    rp = r_params(p)
    for w in (1, 2, 5, 50, 100, 200, 1000):
        assert adjusted_bands(qlens, p, w).tolist() == [
            r_adjusted_band(int(q), rp, w) for q in qlens]
        assert max_gaps(p, qlens, w).tolist() == [
            rpipeline.cal_max_gap(rp, int(q), w) for q in qlens]
    ws = np.resize([1, 7, 100, 333], len(qlens))
    assert adjusted_bands(qlens, p, ws).tolist() == [
        r_adjusted_band(int(q), rp, int(w)) for q, w in zip(qlens, ws)]


def test_one_launch_a_wave(monkeypatch):
    """``run_se_batched`` on a chunk whose waves outgrow the old 256-task
    blocks: one bsw call a non-empty wave (at most 4), the task count of
    the reference's planner, and the empty-sequence tasks short-circuited
    outside the launches."""
    ref = make_reference(40_000, seed=21)
    reads, _ = simulate_reads(ref, 96, 101, seed=22)
    idx = build_contig_index([("ref", ref)])
    calls = []
    real = kbsw.bsw_extend_kernel

    def record(queries, targets, h0s, p, ws=None, qmax=None, tmax=None, **kw):
        calls.append((len(queries), [len(q) for q in queries],
                      [len(t) for t in targets]))
        return real(queries, targets, h0s, p, ws, qmax, tmax, **kw)
    monkeypatch.setattr(kbsw, "bsw_extend_kernel", record)
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        _, st = pipeline.run_se_batched(idx, reads,
                                        pipeline.PipelineOptions(device="cpu"))
    snap = reg.snapshot()
    assert 2 <= len(calls) <= 4
    assert (snap["bsw_dispatches"] == snap["kernel_bsw_dispatches"]
            == len(calls))
    assert max(n for n, _, _ in calls) > 256
    assert all(min(ql) > 0 and min(tl) > 0 for _, ql, tl in calls)
    assert sum(n for n, _, _ in calls) == st["bsw_tasks"]
    _, rst = rpipeline.run_se_batched(
        r_build_contig_index([("ref", ref)]), reads)
    assert st["bsw_tasks"] == rst["bsw_tasks"]
    assert st["cells_useful"] == rst["cells_useful"]
