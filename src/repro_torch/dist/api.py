"""Worker-level sharding of ``mem``: which slice of a FASTQ this process
aligns (``read_shard``) and how it streams it (``align_shard``).

The counterpart of ``repro.dist.api``'s ``read_shard`` and
``align_shard``; the rank comes from ``torch.distributed`` where the
reference asks the jax runtime.
"""

from __future__ import annotations

import time
import warnings

import torch

from .. import obs
from ..io.stream import open_batches


def read_shard(spec: str | None = None) -> tuple[int, int]:
    """This worker's ``(shard_index, shard_count)`` slice of a FASTQ.

    Resolution order: an explicit ``"i/n"`` spec (the ``repro_torch.cli
    mem --shard`` flag, also how a launcher pins ranks) wins; otherwise an
    initialised ``torch.distributed`` process group supplies (rank,
    world size); a process with no group is the whole file, ``(0, 1)``.
    Where ``torch.distributed`` is not available at all, the fallback is
    ``(0, 1)`` too, with a ``RuntimeWarning`` and the
    ``dist_rank_fallback`` counter.  Any other error propagates — a
    silent (0, 1) there would make every worker align every read.  The
    tuple plugs straight into ``repro_torch.io.stream``'s ``shard=``
    filter, whose global-ordinal partition is deterministic and
    batch-size-independent, so n workers each streaming shard (i, n) of
    one FASTQ cover every read exactly once with no coordination.
    """
    if spec:
        try:
            i_s, n_s = spec.split("/")
            i, n = int(i_s), int(n_s)
        except ValueError:
            raise ValueError(f"bad shard spec {spec!r}: expected 'i/n'")
        if not 0 <= i < n:
            raise ValueError(f"bad shard spec {spec!r}: need 0 <= i < n")
        return i, n
    tdist = torch.distributed
    if not tdist.is_available():
        obs.count("dist_rank_fallback")
        warnings.warn(
            "read_shard: torch.distributed is not available; falling back "
            "to unsharded (0, 1) — pass an explicit 'i/n' spec to pin ranks",
            RuntimeWarning, stacklevel=2)
        return 0, 1
    if not tdist.is_initialized():
        return 0, 1
    n = tdist.get_world_size()
    i = tdist.get_rank()
    return (i, n) if n > 1 else (0, 1)


def align_shard(aligner, reads1, reads2=None, out=None, *,
                spec: str | None = None, batch_size: int = 512,
                interleaved: bool = False, header: bool = True,
                cl: str | None = None, monitor=None,
                step: int = 0, runlog=None, export=None,
                total_reads: int | None = None) -> dict:
    """Stream THIS worker's shard of a FASTQ through an ``Aligner``.

    n processes each call ``align_shard(aligner, fq1, fq2, out_i)`` with
    their own output path (shard resolution as in :func:`read_shard`)
    and together cover every read exactly once.

    Returns ``Aligner.stream_sam``'s summary dict extended with the
    shard identity and its wall time (``shard``, ``wall_s``) — the
    ``stats`` entry is an ``obs.Snapshot``, so per-shard summaries merge
    deterministically (``Snapshot.merge_all``, rendered run-wide by
    ``repro_torch.cli report --merge``) into one profile.  When an
    ``ft.straggler.StragglerMonitor`` is passed, the shard's wall time
    feeds its rolling distribution (``monitor.observe``) and a detected
    straggle event is surfaced as ``straggler`` in the summary.

    ``runlog``/``export`` are the run-scoped observability hooks of
    ``Aligner.stream_sam``: with an ``obs.RunLog`` the shard is bracketed
    by ``shard_start``/``shard_end`` events (shard identity, wall time,
    reads/s, straggler verdict) around the per-batch progress stream,
    and an ``obs.LiveExporter`` makes the in-flight shard scrapable.
    """
    shard = read_shard(spec)
    batches = open_batches(reads1, reads2, batch_size=batch_size,
                           interleaved=interleaved, shard=shard)
    if runlog is not None:
        runlog.emit("shard_start", shard=f"{shard[0]}/{shard[1]}",
                    reads1=str(reads1),
                    reads2=None if reads2 is None else str(reads2),
                    out=None if out is None else str(out), step=step)
    t0 = time.perf_counter()
    summary = aligner.stream_sam(batches, out, header=header, cl=cl,
                                 runlog=runlog, export=export,
                                 total_reads=total_reads)
    wall = time.perf_counter() - t0
    summary["shard"] = shard
    summary["wall_s"] = wall
    if monitor is not None:
        summary["straggler"] = monitor.observe(step, host=shard[0],
                                               step_time=wall)
    if runlog is not None:
        ev = summary.get("straggler")
        runlog.emit("shard_end", shard=f"{shard[0]}/{shard[1]}",
                    wall_s=round(wall, 6), n_reads=summary["n_reads"],
                    n_records=summary["n_records"],
                    reads_per_s=(round(summary["n_reads"] / wall, 3)
                                 if wall > 0 else 0.0),
                    straggler=None if ev is None else ev.action)
    return summary
