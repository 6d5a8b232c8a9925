"""Resilient multi-shard ``mem``: checkpointed shard execution, failure
recovery, and a deterministic SAM merge (``repro_torch.cli memdist``).

The paper distributes BWA-MEM over "hundreds of systems"; at that scale a
run must survive worker loss, stragglers and restarts without changing a
single output byte.  This driver turns ``dist.api.align_shard``'s
per-worker streaming into a fault-tolerant job:

1. **Worker-count-invariant decomposition.**  The read set is split into
   bwa ``-K``-style fixed-base chunks (``io.stream.plan_chunks``) — a
   property of the INPUT, not of the worker count — and
   ``ft.elastic.plan_shards`` assigns each worker a CONTIGUOUS chunk
   range.  Concatenating per-shard output in shard order therefore equals
   the unsharded chunk order exactly.
2. **One shared insert-size estimate.**  For paired input, pestat runs
   once on the leading chunk (``Aligner.estimate_pe_stats``) and the
   result is frozen into the job manifest, so PE output cannot depend on
   which shard saw which pairs.
3. **Durable per-shard progress.**  After every chunk a shard saves
   "chunks 0..k done, partial SAM at offset X" through
   ``ft.checkpoint.CheckpointManager`` (atomic tmp -> ``os.replace``).  A
   resumed shard restores the newest usable checkpoint, TRUNCATES its
   partial SAM back to the recorded offset (discarding any half-written
   in-flight chunk) and continues from chunk k+1 — completed work is
   never redone.
4. **Failure handling.**  A shard that raises is retried with capped
   exponential backoff; each retry resumes from the shard's checkpoint
   and is logged as a structured ``shard_retry`` event carrying the
   re-planned remaining range (``ft.elastic.plan_shards`` over the
   chunks still owed).  A shard that exhausts its retries emits
   ``shard_abandoned`` and fails the job.  A
   ``ft.straggler.StragglerMonitor`` fed per-chunk wall times can demand
   a mid-shard requeue (``action == "checkpoint"``): the shard
   checkpoints and re-enters the retry path with ``reason="straggler"``.
5. **Deterministic merge.**  The header (from the one shared ``Aligner``;
   ``@PG`` records the plan) plus the per-shard bodies concatenated in
   shard order, written atomically — byte-identical to an unsharded
   ``repro_torch.cli mem`` run with the same ``-K`` (tested).

Every recovery path is testable on CPU via the fault-injection hook:
``REPRO_FT_INJECT="shard:chunk[:mode]"`` (or an ``inject=`` callable)
kills the chosen shard right before it processes the chosen LOCAL chunk.
``mode`` is ``fail`` (default — the in-process retry path) or ``fatal``
(propagates out of the driver; a rerun over the same workdir resumes
from the checkpoints).  An injection fires ONCE per workdir, recorded by
a durable marker file, so the retried shard proceeds.

The shards are threads of one process over ONE shared ``Aligner``, so
one index on the device.  On a CUDA device their kernel launches all go
to the device's default stream and serialize there, and each shard reads
its results back through that same stream; what overlaps is the host
work between launches, where it releases the interpreter lock.  The
plan, the checkpoints and the injection hook are ``repro.dist.run``'s,
so a workdir either package leaves behind resumes under the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import sys
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from .. import obs
from ..ft import CheckpointManager, plan_shards
from ..ft.elastic import ShardPlan
from ..io.stream import open_batches, plan_chunks
from ..pe.pestat import pestat_from_jsonable, pestat_to_jsonable

PLAN_VERSION = 1
PLAN_FILE = "plan.json"


class ShardFailure(RuntimeError):
    """A shard died (injected or real); retryable by the driver."""


class FatalShardFailure(RuntimeError):
    """An injected ``fatal`` kill: propagates out of ``run_job`` so the
    cross-process resume path (rerun over the same workdir) is testable."""


class StragglerRequeue(RuntimeError):
    """Raised between chunks when the straggler monitor demands the shard
    checkpoint and hand its remainder back to the queue."""


class JobAbandoned(RuntimeError):
    """A shard exhausted its retries; the merged output was NOT written."""


# ---------------------------------------------------------------------
# Job plan (the manifest)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobPlan:
    """Everything a (re)run needs to reproduce the decomposition.

    The plan is frozen to disk (``plan.json``, self-checksummed) before
    any alignment happens; a resumed run validates the stored plan
    against a fresh scan of the inputs, so a changed FASTQ or a changed
    ``chunk_bases`` can never silently splice mismatched shards.
    """
    reads1: str
    reads2: str | None
    interleaved: bool
    chunk_bases: int
    workers: int
    chunks: tuple            # ((n_reads, n_bases), ...) per chunk
    shards: tuple            # ((shard, start, stop), ...)
    pe_stats: tuple | None   # jsonable PairStat[4] rows, or None (SE)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def total_reads(self) -> int:
        return sum(c[0] for c in self.chunks)

    def shard_plans(self) -> list[ShardPlan]:
        return [ShardPlan(*row) for row in self.shards]

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        d["v"] = PLAN_VERSION
        d["checksum"] = _plan_checksum(d)
        return d

    @classmethod
    def from_jsonable(cls, d: dict) -> "JobPlan":
        d = dict(d)
        stored = d.pop("checksum", None)
        if stored != _plan_checksum(d):
            raise ValueError(f"plan checksum mismatch "
                             f"(stored {stored!r}) — refusing to resume")
        if d.pop("v", None) != PLAN_VERSION:
            raise ValueError("unsupported plan version")
        d["chunks"] = tuple(tuple(c) for c in d["chunks"])
        d["shards"] = tuple(tuple(s) for s in d["shards"])
        if d["pe_stats"] is not None:
            d["pe_stats"] = tuple(dict(r) for r in d["pe_stats"])
        return cls(**d)


def _plan_checksum(d: dict) -> str:
    body = {k: v for k, v in d.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode()).hexdigest()


def plan_job(aligner, reads1, reads2=None, *, chunk_bases: int,
             workers: int, interleaved: bool = False) -> JobPlan:
    """Scan the input and freeze the full job decomposition.

    Chunk table from ``plan_chunks`` (the same flush rule the shard
    streamers apply), contiguous shard ranges from
    ``ft.elastic.plan_shards``, and — for paired input — the bootstrap
    insert-size estimate from the leading chunk, frozen as jsonable rows
    (JSON round-trips floats exactly, so freezing cannot perturb output).
    """
    paired = reads2 is not None or interleaved
    chunks = plan_chunks(reads1, reads2, chunk_bases=chunk_bases,
                         interleaved=interleaved)
    if not chunks:
        raise ValueError(f"no reads in {reads1}")
    shards = plan_shards(0, workers, chunk_bases, n_chunks=len(chunks))
    pe_rows = None
    if paired:
        lead = next(iter(open_batches(reads1, reads2,
                                      interleaved=interleaved,
                                      chunk_bases=chunk_bases,
                                      chunk_range=(0, 1))))
        pe_rows = tuple(pestat_to_jsonable(aligner.estimate_pe_stats(lead)))
    return JobPlan(
        reads1=str(reads1),
        reads2=None if reads2 is None else str(reads2),
        interleaved=bool(interleaved), chunk_bases=int(chunk_bases),
        workers=int(workers),
        chunks=tuple((int(r), int(b)) for r, b in chunks),
        shards=tuple((p.shard, p.start, p.stop) for p in shards),
        pe_stats=pe_rows)


def _write_plan(path: pathlib.Path, plan: JobPlan) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(plan.to_jsonable(), indent=1))
    os.replace(tmp, path)


def load_plan(path) -> JobPlan:
    """Load + checksum-verify a frozen ``plan.json``."""
    return JobPlan.from_jsonable(json.loads(pathlib.Path(path).read_text()))


# ---------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------

def _parse_inject(spec: str | None):
    """``"shard:chunk[:mode]"`` -> (shard, chunk, mode) or None."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"bad REPRO_FT_INJECT {spec!r}: "
                         f"expected 'shard:chunk[:mode]'")
    mode = parts[2] if len(parts) == 3 else "fail"
    if mode not in ("fail", "fatal"):
        raise ValueError(f"bad REPRO_FT_INJECT mode {mode!r}: "
                         f"expected 'fail' or 'fatal'")
    return int(parts[0]), int(parts[1]), mode


def _env_injector(workdir: pathlib.Path, spec: str | None):
    """Once-per-workdir injected kill, durable across process restarts.

    Returns ``inject(shard, local_chunk)`` or None.  The marker file is
    written BEFORE raising, so neither the in-process retry nor a fresh
    process over the same workdir re-fires the same kill.
    """
    parsed = _parse_inject(spec)
    if parsed is None:
        return None
    t_shard, t_chunk, mode = parsed
    marker = workdir / f"inject_{t_shard}_{t_chunk}.fired"

    def inject(shard: int, local_chunk: int) -> None:
        if shard != t_shard or local_chunk != t_chunk or marker.exists():
            return
        marker.write_text(f"{time.time()}\n")
        exc = (FatalShardFailure if mode == "fatal" else ShardFailure)
        raise exc(f"injected {mode} kill: shard {shard} at local chunk "
                  f"{local_chunk} (REPRO_FT_INJECT)")

    return inject


# ---------------------------------------------------------------------
# Per-shard execution
# ---------------------------------------------------------------------

def _ckpt_like() -> dict:
    return {"chunks_done": np.int64(0), "sam_offset": np.int64(0),
            "n_reads": np.int64(0), "n_records": np.int64(0)}


def _shard_paths(workdir: pathlib.Path, shard: int):
    return workdir / f"shard_{shard:04d}.sam", workdir / f"ckpt_shard_{shard}"


def _run_shard(aligner, plan: JobPlan, sp: ShardPlan,
               workdir: pathlib.Path, *, runlog=None, inject=None,
               monitor=None, monitor_lock=None, engine=None) -> dict:
    """Align one shard's chunk range, checkpointing after every chunk.

    Restores prior progress (skipping completed chunks and truncating the
    partial SAM to the checkpointed offset) before streaming; safe to
    call again after any failure.  Returns the shard summary.
    """
    sam_path, ckpt_dir = _shard_paths(workdir, sp.shard)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    done, offset, n_reads, n_records = 0, 0, 0, 0
    resumed = False
    if mgr.steps():
        state, _step = mgr.restore(_ckpt_like())
        done = int(state["chunks_done"])
        offset = int(state["sam_offset"])
        n_reads = int(state["n_reads"])
        n_records = int(state["n_records"])
        resumed = done > 0 or offset > 0
    if not sam_path.exists():
        sam_path.touch()
        offset = 0
    fh = open(sam_path, "r+b")
    try:
        fh.truncate(offset)          # discard any half-written chunk
        fh.seek(offset)
        if runlog is not None:
            runlog.emit("shard_start", shard=sp.shard,
                        chunk_start=sp.start, chunk_stop=sp.stop,
                        resumed=resumed, chunks_done=done,
                        sam_offset=offset)
        t0 = time.perf_counter()
        batches = open_batches(plan.reads1, plan.reads2,
                               interleaved=plan.interleaved,
                               chunk_bases=plan.chunk_bases,
                               chunk_range=(sp.start + done, sp.stop))
        for j, batch in enumerate(batches):
            local = done + j
            if inject is not None:
                inject(sp.shard, local)
            ct0 = time.perf_counter()
            if hasattr(batch, "reads1"):
                res = aligner.align_pairs(batch, engine=engine)
                n_reads += 2 * len(batch)
            else:
                res = aligner.align(batch, engine=engine)
                n_reads += len(batch)
            body = "".join(ln + "\n" for ln in res.sam())
            fh.write(body.encode())
            fh.flush()
            os.fsync(fh.fileno())
            offset = fh.tell()
            n_records += res.n_records
            mgr.save(local + 1, {"chunks_done": np.int64(local + 1),
                                 "sam_offset": np.int64(offset),
                                 "n_reads": np.int64(n_reads),
                                 "n_records": np.int64(n_records)})
            chunk_s = time.perf_counter() - ct0
            if runlog is not None:
                runlog.emit("shard_batch", shard=sp.shard,
                            chunk=sp.start + local, local_chunk=local,
                            reads=(2 * len(batch)
                                   if hasattr(batch, "reads1")
                                   else len(batch)),
                            records=res.n_records, sam_offset=offset,
                            chunk_s=round(chunk_s, 6))
            if monitor is not None and local + 1 < sp.n_chunks:
                with (monitor_lock or threading.Lock()):
                    ev = monitor.observe(sp.start + local, host=sp.shard,
                                         step_time=chunk_s)
                if ev is not None and ev.action == "checkpoint":
                    raise StragglerRequeue(
                        f"shard {sp.shard} straggling at chunk "
                        f"{sp.start + local} ({ev.step_time:.3f}s vs "
                        f"median {ev.median:.3f}s); requeueing remainder")
        wall = time.perf_counter() - t0
        if runlog is not None:
            runlog.emit("shard_end", shard=sp.shard, wall_s=round(wall, 6),
                        n_reads=n_reads, n_records=n_records,
                        chunks=sp.n_chunks, sam_bytes=offset,
                        resumed=resumed)
        return {"shard": sp.shard, "n_reads": n_reads,
                "n_records": n_records, "wall_s": wall,
                "sam_bytes": offset, "resumed": resumed}
    finally:
        fh.close()


# ---------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------

def run_job(aligner, reads1, reads2=None, out=None, *,
            workdir, workers: int = 3, chunk_bases: int = 100_000,
            interleaved: bool = False, header: bool = True,
            cl: str | None = None, engine: str | None = None,
            max_retries: int = 2, retry_backoff_s: float = 0.05,
            runlog=None, monitor=None, inject=None,
            keep_workdir: bool = False) -> dict:
    """Run (or resume) a resilient multi-shard ``mem`` job.

    Plans (or revalidates) the decomposition, executes every shard on a
    worker pool with per-chunk checkpointing and capped-backoff retries,
    then merges the per-shard SAMs deterministically into ``out``.
    ``workdir`` is the job's durable scratch: rerunning with the same
    workdir resumes; after a successful merge it is removed unless
    ``keep_workdir``.

    ``inject`` overrides the ``REPRO_FT_INJECT`` env hook (callable
    ``(shard, local_chunk)`` raising to kill the shard at that point).
    Returns a summary dict (per-shard stats, retry/abandon counters,
    merge bytes, wall time).
    """
    t_start = time.perf_counter()
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    plan_path = workdir / PLAN_FILE

    fresh = plan_job(aligner, reads1, reads2, chunk_bases=chunk_bases,
                     workers=workers, interleaved=interleaved)
    if plan_path.exists():
        plan = load_plan(plan_path)
        # the input may legally be re-planned over a different worker
        # count (elastic resume), but the chunk decomposition — and the
        # frozen insert-size stats — must match what the shards already
        # aligned against
        if (plan.chunks != fresh.chunks
                or plan.chunk_bases != fresh.chunk_bases
                or plan.reads1 != fresh.reads1
                or plan.reads2 != fresh.reads2
                or plan.pe_stats != fresh.pe_stats):
            raise ValueError(
                f"{plan_path}: stored plan does not match the current "
                f"inputs; refusing to resume (delete the workdir to start "
                f"over)")
        resumed_job = True
    else:
        plan = fresh
        _write_plan(plan_path, plan)
        resumed_job = False

    if plan.pe_stats is not None:
        aligner.pe_stats = pestat_from_jsonable(
            [dict(r) for r in plan.pe_stats])

    if inject is None:
        inject = _env_injector(workdir, os.environ.get("REPRO_FT_INJECT"))
    shard_plans = plan.shard_plans()
    if runlog is not None:
        runlog.emit("job_plan", workers=plan.workers,
                    chunk_bases=plan.chunk_bases, n_chunks=plan.n_chunks,
                    n_shards=len(shard_plans),
                    total_reads=plan.total_reads,
                    shards=[[p.shard, p.start, p.stop]
                            for p in shard_plans],
                    pe_frozen=plan.pe_stats is not None,
                    resumed=resumed_job)

    monitor_lock = threading.Lock()
    retries = {p.shard: 0 for p in shard_plans}
    summaries: dict[int, dict] = {}
    n_retries = 0

    def attempt(sp: ShardPlan) -> dict:
        return _run_shard(aligner, plan, sp, workdir, runlog=runlog,
                          inject=inject, monitor=monitor,
                          monitor_lock=monitor_lock, engine=engine)

    with ThreadPoolExecutor(max_workers=len(shard_plans)) as pool:
        pending = {pool.submit(attempt, sp): sp for sp in shard_plans}
        while pending:
            finished, _ = wait(pending, return_when=FIRST_COMPLETED)
            for fut in finished:
                sp = pending.pop(fut)
                try:
                    summaries[sp.shard] = fut.result()
                    continue
                except FatalShardFailure:
                    if runlog is not None:
                        runlog.emit("shard_fatal", shard=sp.shard)
                    raise
                except Exception as e:  # noqa: BLE001 — the retry path
                    attempt_n = retries[sp.shard] = retries[sp.shard] + 1
                    remaining = _remaining_range(workdir, sp)
                    if attempt_n > max_retries:
                        if runlog is not None:
                            runlog.emit("shard_abandoned", shard=sp.shard,
                                        attempts=attempt_n,
                                        exc_type=type(e).__name__,
                                        exc=str(e),
                                        remaining=list(remaining))
                        raise JobAbandoned(
                            f"shard {sp.shard} failed {attempt_n} times "
                            f"(last: {e}); chunks "
                            f"{remaining[0]}..{remaining[1]} not aligned"
                        ) from e
                    # elastic-style re-plan of the remainder: same chunk
                    # ordinals, re-split for the (single) replacement
                    # worker — logged so a scheduler could reassign it
                    replan = plan_shards(0, 1, plan.chunk_bases,
                                         n_chunks=remaining[1]
                                         - remaining[0])
                    backoff = retry_backoff_s * (2 ** (attempt_n - 1))
                    if runlog is not None:
                        runlog.emit(
                            "shard_retry", shard=sp.shard,
                            attempt=attempt_n,
                            reason=("straggler"
                                    if isinstance(e, StragglerRequeue)
                                    else "failure"),
                            exc_type=type(e).__name__, exc=str(e),
                            remaining=list(remaining),
                            replan=[[remaining[0] + q.start,
                                     remaining[0] + q.stop]
                                    for q in replan],
                            backoff_s=backoff)
                    obs.count("dist_shard_retries")
                    if backoff > 0:
                        time.sleep(backoff)
                    pending[pool.submit(attempt, sp)] = sp
        n_retries = sum(retries.values())

    merged = _merge(aligner, shard_plans, workdir, out, header=header,
                    cl=cl, runlog=runlog)
    wall = time.perf_counter() - t_start
    if runlog is not None:
        runlog.emit("job_end", status="ok", wall_s=round(wall, 6),
                    n_reads=sum(s["n_reads"] for s in summaries.values()),
                    n_records=sum(s["n_records"]
                                  for s in summaries.values()),
                    retries=n_retries, merged_bytes=merged["merged_bytes"])
    summary = {
        "n_reads": sum(s["n_reads"] for s in summaries.values()),
        "n_records": sum(s["n_records"] for s in summaries.values()),
        "n_shards": len(shard_plans), "n_chunks": plan.n_chunks,
        "retries": n_retries, "resumed": resumed_job,
        "shards": [summaries[p.shard] for p in shard_plans],
        "wall_s": wall, **merged}
    if not keep_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    return summary


def _remaining_range(workdir: pathlib.Path, sp: ShardPlan):
    """(first unfinished global chunk, stop) from the shard's checkpoint."""
    _, ckpt_dir = _shard_paths(workdir, sp.shard)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    done = 0
    if mgr.steps():
        try:
            state, _ = mgr.restore(_ckpt_like())
            done = int(state["chunks_done"])
        except FileNotFoundError:
            done = 0
    return sp.start + done, sp.stop


def _merge(aligner, shard_plans, workdir: pathlib.Path, out, *,
           header: bool, cl: str | None, runlog=None) -> dict:
    """Header + per-shard bodies concatenated in shard order, atomically.

    Shard ranges are contiguous and ordered, so this concatenation IS the
    unsharded chunk order — the whole merge is I/O, no record sorting.
    """
    t0 = time.perf_counter()
    per_shard = []
    close = False
    if out is None:
        fh, tmp = sys.stdout.buffer, None
    elif hasattr(out, "write"):
        fh, tmp = out, None
    else:
        tmp = pathlib.Path(str(out) + ".tmp")
        fh = open(tmp, "wb")
        close = True
    try:
        if header:
            head = "".join(ln + "\n" for ln in aligner.sam_header(cl=cl))
            fh.write(head.encode())
        for sp in shard_plans:
            sam_path, _ = _shard_paths(workdir, sp.shard)
            data = sam_path.read_bytes()
            fh.write(data)
            per_shard.append(len(data))
        fh.flush()
    finally:
        if close:
            fh.close()
    if tmp is not None:
        os.replace(tmp, out)
    merge_s = time.perf_counter() - t0
    merged = sum(per_shard)
    if runlog is not None:
        runlog.emit("merge", out=None if out is None or
                    hasattr(out, "write") else str(out),
                    shards=len(per_shard), shard_bytes=per_shard,
                    merged_bytes=merged, merge_s=round(merge_s, 6))
    return {"merged_bytes": merged, "merge_s": merge_s}
