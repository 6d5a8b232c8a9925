"""Runtime side of the distribution layer: worker-level sharding of
``mem`` (``read_shard``, ``align_shard``), and the ambient mesh and
option flags that model code reads (``get_option``, ``options``,
``constrain``).

The counterpart of ``repro.dist.api``.  The rank comes from
``torch.distributed`` where the reference asks the jax runtime, and the
ambient mesh is a ``torch.distributed.device_mesh.DeviceMesh``.

Model code never imports a mesh directly.  It calls ``constrain(x,
...)`` with LOGICAL axis names ("batch", "model", None); with no active
mesh the call returns ``x`` unchanged, which is what lets the same model
run on one device.  Laying a tensor out over a mesh is the job of the
sharding layer, which the port does not have yet: under an active mesh
``constrain`` raises instead of silently leaving ``x`` where it is.

Options ("seq_parallel", "moe_ep", "moe_gather_w", "moe_groups",
"dp_all") are scoped, thread-local flags read by model code via
``get_option`` so a variant sweep never threads config through every
call.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import torch

from .. import obs
from ..io.stream import open_batches

_STATE = threading.local()


def _opts() -> dict:
    if not hasattr(_STATE, "options"):
        _STATE.options = {}
    return _STATE.options


def get_option(name: str, default=None):
    """Current value of a distribution option (None when unset)."""
    return _opts().get(name, default)


@contextlib.contextmanager
def options(**kw):
    """Scoped option overrides (nestable; restores previous values)."""
    prev = dict(_opts())
    _opts().update(kw)
    try:
        yield
    finally:
        _STATE.options = prev


def current_mesh():
    """The active ``DeviceMesh`` of this thread, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh for
    ``constrain`` calls."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def batch_mesh_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over.  Normally the pure-DP
    axes; with the ``dp_all`` option every mesh axis acts data-parallel."""
    names = tuple(mesh.mesh_dim_names or ())
    if get_option("dp_all"):
        return names
    return tuple(a for a in ("pod", "data") if a in names)


def constrain(x, *axes):
    """Sharding constraint by logical axis name per tensor dim.

    Returns ``x`` unchanged without an active mesh, as the reference
    does.  Under an active mesh it raises ``NotImplementedError``: the
    layout of a tensor over a ``DeviceMesh`` belongs to the sharding
    layer (``dist/sharding.py``), which the port does not have yet.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    raise NotImplementedError(
        f"constrain{axes!r} under an active mesh "
        f"{tuple(mesh.mesh_dim_names or ())!r}: sharding over a DeviceMesh "
        f"needs the sharding layer (dist/sharding.py), not ported yet")


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
