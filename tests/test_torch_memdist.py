"""Resilient multi-shard ``mem`` of the port (``repro_torch.dist.run``,
``repro_torch.cli memdist``) against the reference (``repro.cli memdist
--engine pallas``), on the CPU.

The claims, byte for byte (``--no-pg``): the port's merged SAM equals the
reference's and the port's own unsharded ``mem -K`` (``--pe-bootstrap``
for pairs) at 1, 2 and 3 workers, after an injected ``fail`` kill (in
process retry), after a ``fatal`` kill and a rerun, and when the port
resumes a workdir the reference left behind.  A resumed shard SKIPS its
completed chunks (run-log chunk counters strictly resume).  The rank
resolution of ``read_shard`` follows ``torch.distributed``, the launch
counters lose no count under threads, and ``cli memdist`` without a card
exits with an error.
"""

import json
import sys
import threading
import types
import warnings

import pytest
import torch

from repro import cli as rcli
from repro.api import Aligner as RAligner
from repro.api import AlignOptions as RAlignOptions
from repro.dist import run as rrun
from repro.io.store import load_index as rload_index
from repro_torch import cli as tcli
from repro_torch import obs
from repro_torch.api import Aligner
from repro_torch.data import (make_reference, simulate_pairs_multi,
                              simulate_reads_multi, write_fasta, write_fastq,
                              write_fastq_pair)
from repro_torch.dist import api as dist_api
from repro_torch.dist.run import (FatalShardFailure, JobAbandoned,
                                  ShardFailure, load_plan, plan_job, run_job)
from repro_torch.ft.straggler import StragglerEvent
from repro_torch.io.store import load_index
from repro_torch.io.stream import check_chunking, open_batches, plan_chunks
from repro_torch.kernels import build, launch_counts, reset_launch_counts

torch.set_num_threads(1)

CONTIGS = [("chr1", make_reference(6000, seed=3)),
           ("chr2", make_reference(4000, seed=4))]
N_READS = 12
SE_CB = 300         # 12 reads x 101 bp -> 4 chunks: shards of 2/1/1
N_PAIRS = 32
#: 32 pairs x 202 bp -> 2 chunks of 24 and 8 pairs.  The leading chunk
#: is large enough (and the seed one) for its FR insert-size stats to
#: succeed, so the frozen stats drive mate rescue in every shard.
PE_CB = 4848


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_memdist")
    fa = str(d / "ref.fa")
    write_fasta(fa, CONTIGS)
    assert tcli.main(["index", fa]) == 0
    reads, _ = simulate_reads_multi(CONTIGS, N_READS, 101, seed=5)
    se = str(d / "se.fq")
    write_fastq(se, reads, [f"r{i}" for i in range(N_READS)])
    r1, r2, _ = simulate_pairs_multi(CONTIGS, N_PAIRS, 101, seed=7,
                                     insert_mean=300, insert_std=30,
                                     burst_frac=0.1)
    p1, p2 = str(d / "r1.fq"), str(d / "r2.fq")
    write_fastq_pair(p1, p2, r1, r2)
    return types.SimpleNamespace(d=d, fa=fa, se=se, p1=p1, p2=p2,
                                 idx=load_index(fa))


def read(path) -> str:
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def se_mem_sam(world):
    """The port's unsharded ``mem -K``: what every memdist must equal."""
    out = world.d / "se_mem.sam"
    assert tcli.main(["mem", world.fa, world.se, "-K", str(SE_CB),
                      "--device", "cpu", "--no-pg", "-o", str(out)]) == 0
    return read(out)


@pytest.fixture(scope="module")
def se_ref_memdist_sam(world):
    """``repro.cli memdist --engine pallas`` (3 workers; its bytes do not
    depend on the worker count, as the reference's own tests hold)."""
    out = world.d / "se_ref_memdist.sam"
    assert rcli.main(["memdist", world.fa, world.se, "-K", str(SE_CB),
                      "-n", "3", "--no-pg", "--engine", "pallas",
                      "-o", str(out)]) == 0
    return read(out)


@pytest.fixture(scope="module")
def pe_mem_sam(world):
    out = world.d / "pe_mem.sam"
    assert tcli.main(["mem", world.fa, world.p1, world.p2, "-K", str(PE_CB),
                      "--pe-bootstrap", "--device", "cpu", "--no-pg",
                      "-o", str(out)]) == 0
    return read(out)


def cpu_aligner(world) -> Aligner:
    return Aligner.from_index(world.idx, device="cpu")


def _once_injector(*, shard: int, chunk: int, fatal: bool = False):
    fired = []

    def inject(s, c):
        if s == shard and c == chunk and not fired:
            fired.append(True)
            raise (FatalShardFailure if fatal else ShardFailure)(
                f"injected kill: shard {s} chunk {c}")

    return inject


# ---------------------------------------------------------------------
# Fixed-base chunking (io/stream)
# ---------------------------------------------------------------------

def test_plan_chunks_matches_streamed_batches(world):
    plan = plan_chunks(world.se, chunk_bases=SE_CB)
    got = [(len(b.names), int(b.lens.sum()))
           for b in open_batches(world.se, chunk_bases=SE_CB)]
    assert got == plan
    assert len(plan) == 4
    assert all(b >= SE_CB for _, b in plan[:-1])


def test_chunk_range_is_a_window_of_the_same_decomposition(world):
    full = list(open_batches(world.se, chunk_bases=SE_CB))
    window = list(open_batches(world.se, chunk_bases=SE_CB,
                               chunk_range=(1, 3)))
    assert [b.names for b in window] == [b.names for b in full[1:3]]


def test_chunked_shards_cover_input_in_order(world):
    full = [n for b in open_batches(world.se, chunk_bases=SE_CB)
            for n in b.names]
    pieces = []
    for lo, hi in ((0, 2), (2, 3), (3, 4)):
        pieces += [n for b in open_batches(world.se, chunk_bases=SE_CB,
                                           chunk_range=(lo, hi))
                   for n in b.names]
    assert pieces == full


def test_pair_chunks_count_both_ends_and_never_split_pairs(world):
    plan = plan_chunks(world.p1, world.p2, chunk_bases=PE_CB)
    assert len(plan) == 2
    batches = list(open_batches(world.p1, world.p2, chunk_bases=PE_CB))
    for (n_reads, n_bases), b in zip(plan, batches):
        assert n_reads == 2 * len(b.names)
        assert n_bases == int(b.lens1.sum() + b.lens2.sum())


def test_check_chunking_validation():
    assert check_chunking(None, None) == (None, None)
    assert check_chunking(100, (1, 3)) == (100, (1, 3))
    with pytest.raises(ValueError):
        check_chunking(None, (0, 2))
    with pytest.raises(ValueError):
        check_chunking(0, None)
    with pytest.raises(ValueError):
        check_chunking(100, (3, 1))


# ---------------------------------------------------------------------
# The resilient driver against the reference
# ---------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2, 3])
def test_memdist_se_matches_reference_cli(world, se_mem_sam,
                                          se_ref_memdist_sam, workers):
    out_t = world.d / f"se_w{workers}.torch.sam"
    assert tcli.main(["memdist", world.fa, world.se, "-K", str(SE_CB), "-n",
                      str(workers), "--no-pg", "--device", "cpu",
                      "-o", str(out_t)]) == 0
    assert read(out_t) == se_ref_memdist_sam == se_mem_sam
    assert not (world.d / f"se_w{workers}.torch.sam.work").exists()


def test_memdist_injected_kill_retries_and_stays_identical(
        world, se_mem_sam, tmp_path):
    """One shard killed mid-run: auto-retry resumes from its checkpoint,
    the merged SAM is still byte-identical, the run log shows exactly one
    shard_retry, and the retried shard's chunk counters strictly RESUME."""
    rl_path = tmp_path / "run.jsonl"
    out = tmp_path / "merged.sam"
    with obs.RunLog(rl_path) as rl:
        summ = run_job(cpu_aligner(world), world.se, out=out,
                       workdir=tmp_path / "wd", workers=3,
                       chunk_bases=SE_CB, cl=None, runlog=rl,
                       retry_backoff_s=0.0,
                       inject=_once_injector(shard=0, chunk=1))
    assert read(out) == se_mem_sam
    assert summ["retries"] == 1
    evs = obs.read_runlog(rl_path)
    retries = [e for e in evs if e["event"] == "shard_retry"]
    assert len(retries) == 1
    assert retries[0]["shard"] == 0 and retries[0]["reason"] == "failure"
    assert retries[0]["replan"]
    starts = [e for e in evs
              if e["event"] == "shard_start" and e["shard"] == 0]
    assert [e["resumed"] for e in starts] == [False, True]
    assert starts[1]["chunks_done"] >= 1
    done = [e["local_chunk"] for e in evs
            if e["event"] == "shard_batch" and e["shard"] == 0]
    assert done == sorted(done) and len(done) == len(set(done))


def test_memdist_cli_env_injected_fail_kill(world, se_mem_sam, tmp_path,
                                             monkeypatch):
    """``REPRO_FT_INJECT`` drives the port's CLI as it drives the
    reference's: one in-process retry, the same bytes."""
    monkeypatch.setenv("REPRO_FT_INJECT", "0:1")
    out, rl = tmp_path / "out.sam", tmp_path / "run.jsonl"
    assert tcli.main(["memdist", world.fa, world.se, "-K", str(SE_CB),
                      "-n", "3", "--device", "cpu", "--no-pg",
                      "--retry-backoff", "0", "--runlog", str(rl),
                      "-o", str(out)]) == 0
    assert read(out) == se_mem_sam
    evs = obs.read_runlog(rl)
    assert [e["shard"] for e in evs if e["event"] == "shard_retry"] == [0]
    assert evs[0]["tool"] == "repro_torch.cli memdist"
    assert evs[-1]["event"] == "run_end" and evs[-1]["retries"] == 1


def test_memdist_pe_bootstrap_matches_reference_with_retry(
        world, pe_mem_sam, tmp_path):
    """PE across two contigs: the leading chunk's frozen insert stats make
    the sharded run byte-identical to the reference's memdist and to the
    port's ``mem -K --pe-bootstrap``, even with an injected shard kill."""
    al = cpu_aligner(world)
    out = tmp_path / "pe.sam"
    summ = run_job(al, world.p1, world.p2, out=out, workdir=tmp_path / "wd",
                   workers=2, chunk_bases=PE_CB, cl=None,
                   retry_backoff_s=0.0,
                   inject=_once_injector(shard=1, chunk=0))
    assert summ["retries"] == 1 and summ["n_shards"] == 2
    assert al.pe_stats is not None and not al.pe_stats[1].failed
    out_r = tmp_path / "pe.ref.sam"
    assert rcli.main(["memdist", world.fa, world.p1, world.p2, "-K",
                      str(PE_CB), "-n", "2", "--engine", "pallas",
                      "--no-pg", "-o", str(out_r)]) == 0
    assert read(out) == read(out_r) == pe_mem_sam


def test_memdist_fatal_kill_then_fresh_run_resumes(
        world, se_mem_sam, tmp_path):
    """A fatal kill propagates (no merged output); a FRESH run_job over
    the same workdir restores every shard's checkpoint, skips completed
    chunks, and merges byte-identically."""
    wd, out = tmp_path / "wd", tmp_path / "out.sam"
    with pytest.raises(FatalShardFailure):
        run_job(cpu_aligner(world), world.se, out=out, workdir=wd,
                workers=3, chunk_bases=SE_CB, cl=None, retry_backoff_s=0.0,
                inject=_once_injector(shard=0, chunk=1, fatal=True))
    assert not out.exists()
    assert (wd / "plan.json").exists()
    rl_path = tmp_path / "resume.jsonl"
    with obs.RunLog(rl_path) as rl:
        summ = run_job(cpu_aligner(world), world.se, out=out, workdir=wd,
                       workers=3, chunk_bases=SE_CB, cl=None, runlog=rl,
                       retry_backoff_s=0.0)
    assert read(out) == se_mem_sam
    assert summ["resumed"]
    evs = obs.read_runlog(rl_path)
    s0 = [e for e in evs if e["event"] == "shard_batch" and e["shard"] == 0]
    assert s0 and min(e["local_chunk"] for e in s0) >= 1
    starts = [e for e in evs
              if e["event"] == "shard_start" and e["shard"] == 0]
    assert starts[0]["resumed"] and starts[0]["chunks_done"] >= 1


def test_memdist_cli_fatal_kill_then_rerun(world, se_mem_sam, tmp_path,
                                           monkeypatch):
    """The CLI's fatal path: exit 3 with the work checkpointed, then the
    same command again resumes (the injection fired once per workdir)."""
    monkeypatch.setenv("REPRO_FT_INJECT", "0:1:fatal")
    out = tmp_path / "out.sam"
    argv = ["memdist", world.fa, world.se, "-K", str(SE_CB), "-n", "3",
            "--device", "cpu", "--no-pg", "-o", str(out)]
    assert tcli.main(argv) == 3
    assert not out.exists()
    assert (tmp_path / "out.sam.work" / "plan.json").exists()
    assert tcli.main(argv) == 0
    assert read(out) == se_mem_sam
    assert not (tmp_path / "out.sam.work").exists()


def test_memdist_resumes_a_reference_workdir(world, se_mem_sam, tmp_path):
    """A workdir the reference's fatal kill left behind (plan.json,
    per-shard SAMs, checkpoints) resumes under the port: the plan
    validates, completed chunks are skipped, the bytes are the same."""
    wd, out = tmp_path / "wd", tmp_path / "out.sam"
    ral = RAligner.from_index(rload_index(world.fa),
                              RAlignOptions(engine="pallas"))

    def kill(shard, chunk):
        if (shard, chunk) == (0, 1):
            raise rrun.FatalShardFailure("injected fatal kill")

    with pytest.raises(rrun.FatalShardFailure):
        rrun.run_job(ral, world.se, out=out, workdir=wd, workers=3,
                     chunk_bases=SE_CB, cl=None, retry_backoff_s=0.0,
                     inject=kill)
    ref_plan = json.loads((wd / "plan.json").read_text())
    # the port reads the reference's plan back to the same JSON
    assert json.loads(json.dumps(
        load_plan(wd / "plan.json").to_jsonable())) == ref_plan
    rl_path = tmp_path / "resume.jsonl"
    with obs.RunLog(rl_path) as rl:
        summ = run_job(cpu_aligner(world), world.se, out=out, workdir=wd,
                       workers=3, chunk_bases=SE_CB, cl=None, runlog=rl)
    assert summ["resumed"]
    assert read(out) == se_mem_sam
    starts = {e["shard"]: e for e in obs.read_runlog(rl_path)
              if e["event"] == "shard_start"}
    assert starts[0]["resumed"] and starts[0]["chunks_done"] == 1


def test_memdist_straggler_requeue(world, se_mem_sam, tmp_path):
    """A monitor demanding action="checkpoint" requeues the shard's
    remainder; the retried shard resumes and output is unchanged."""
    class DemandRequeue:
        def __init__(self):
            self.fired = False

        def observe(self, step, host=0, step_time=0.0):
            if host == 0 and not self.fired:
                self.fired = True
                return StragglerEvent(step=step, host=host,
                                      step_time=step_time, median=1e-9,
                                      action="checkpoint")
            return None

    rl_path = tmp_path / "run.jsonl"
    out = tmp_path / "out.sam"
    with obs.RunLog(rl_path) as rl:
        summ = run_job(cpu_aligner(world), world.se, out=out,
                       workdir=tmp_path / "wd", workers=3,
                       chunk_bases=SE_CB, cl=None, runlog=rl,
                       retry_backoff_s=0.0, monitor=DemandRequeue())
    assert read(out) == se_mem_sam
    assert summ["retries"] == 1
    retries = [e for e in obs.read_runlog(rl_path)
               if e["event"] == "shard_retry"]
    assert len(retries) == 1 and retries[0]["reason"] == "straggler"


def test_memdist_retry_cap_abandons(world, tmp_path):
    """A shard that keeps dying is abandoned after max_retries; the run
    log records shard_abandoned and no merged output appears."""
    def always_kill(shard, chunk):
        if shard == 1:
            raise ShardFailure("flaky forever")

    rl_path = tmp_path / "run.jsonl"
    out = tmp_path / "out.sam"
    with obs.RunLog(rl_path) as rl:
        with pytest.raises(JobAbandoned):
            run_job(cpu_aligner(world), world.se, out=out,
                    workdir=tmp_path / "wd", workers=3, chunk_bases=SE_CB,
                    cl=None, runlog=rl, max_retries=2, retry_backoff_s=0.0,
                    inject=always_kill)
    assert not out.exists()
    evs = obs.read_runlog(rl_path)
    assert sum(e["event"] == "shard_retry" for e in evs) == 2
    abandoned = [e for e in evs if e["event"] == "shard_abandoned"]
    assert len(abandoned) == 1 and abandoned[0]["shard"] == 1


def test_memdist_plan_tamper_and_input_mismatch_rejected(world, tmp_path):
    al = cpu_aligner(world)
    wd = tmp_path / "wd"
    with pytest.raises(FatalShardFailure):
        run_job(al, world.se, workdir=wd, out=tmp_path / "o.sam", workers=3,
                chunk_bases=SE_CB, cl=None, retry_backoff_s=0.0,
                inject=_once_injector(shard=0, chunk=0, fatal=True))
    plan_path = wd / "plan.json"
    d = json.loads(plan_path.read_text())
    d["chunk_bases"] = 999
    plan_path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="checksum"):
        load_plan(plan_path)
    fresh = plan_job(al, world.se, chunk_bases=2 * SE_CB, workers=3)
    # the port's plan is the reference's, checksum included
    plan_path.write_text(json.dumps(fresh.to_jsonable()))
    assert rrun.load_plan(plan_path).to_jsonable() == fresh.to_jsonable()
    with pytest.raises(ValueError, match="does not match"):
        run_job(al, world.se, workdir=wd, out=tmp_path / "o.sam", workers=3,
                chunk_bases=SE_CB, cl=None)


def test_memdist_pg_header_records_plan(world, tmp_path):
    out = tmp_path / "out.sam"
    assert tcli.main(["memdist", world.fa, world.se, "-K", str(SE_CB),
                      "-n", "1", "--device", "cpu", "-o", str(out)]) == 0
    pg = [ln for ln in read(out).splitlines() if ln.startswith("@PG")]
    assert len(pg) == 1
    assert pg[0].endswith(f"CL:repro_torch.cli memdist -K {SE_CB} -n 1")


def test_memdist_without_cuda_exits_nonzero(world, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.sam"
    assert tcli.main(["memdist", world.fa, world.se, "-K", str(SE_CB),
                      "-o", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists() and not (tmp_path / "out.sam.work").exists()


# ---------------------------------------------------------------------
# read_shard: the rank from torch.distributed
# ---------------------------------------------------------------------

def test_read_shard_backend_fallback_warns(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_available", lambda: False)
    reg = obs.MetricsRegistry()
    with warnings.catch_warnings(record=True) as w, obs.activate(reg):
        warnings.simplefilter("always")
        assert dist_api.read_shard() == (0, 1)
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    assert reg.snapshot()["dist_rank_fallback"] == 1


def test_read_shard_other_errors_propagate(monkeypatch):
    def boom():
        raise OSError("mis-configured store")

    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", boom,
                        raising=False)
    with pytest.raises(OSError):
        dist_api.read_shard()


def test_read_shard_explicit_spec_still_wins(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_available",
                        lambda: (_ for _ in ()).throw(RuntimeError("nope")))
    assert dist_api.read_shard("2/5") == (2, 5)
    for bad in ("2", "a/b", "5/5", "-1/3"):
        with pytest.raises(ValueError, match="bad shard spec"):
            dist_api.read_shard(bad)


@pytest.mark.parametrize("initialized,rank,world_size,want", [
    (True, 2, 5, (2, 5)), (True, 0, 1, (0, 1)), (False, 3, 4, (0, 1))])
def test_read_shard_from_process_group(monkeypatch, initialized, rank,
                                       world_size, want):
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: initialized)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank,
                        raising=False)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda: world_size, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dist_api.read_shard() == want


# ---------------------------------------------------------------------
# Launch counters under threads
# ---------------------------------------------------------------------

def test_launch_counters_lose_no_count_under_threads():
    """8 threads bump one counter through the locked helper while a
    short switch interval forces them to interleave: no count is lost,
    and a reset between two reads is seen whole."""
    n_threads, n_bumps = 8, 5000
    reset_launch_counts()
    start = threading.Barrier(n_threads)

    def bump():
        start.wait(timeout=30)
        for _ in range(n_bumps):
            build.count_launch("bsw")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["bsw"] == n_threads * n_bumps
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
