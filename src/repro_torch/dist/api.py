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
run on one device.  Under an active mesh ``x`` is a DTensor, and
``constrain`` redistributes it to the layout the names give (the
reference's ``with_sharding_constraint``).

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
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed._functional_collectives import AsyncCollectiveTensor

from .. import obs
from ..io.stream import open_batches
from .sharding import P, Sharding, require_even

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


def ambient():
    """This thread's current mesh and options, as a function giving a
    context manager that enters them again wherever it is used: for work
    that runs later on another thread, as autograd's recomputation of a
    checkpointed block does on the card's backward thread."""
    mesh, opts = current_mesh(), dict(_opts())

    @contextlib.contextmanager
    def enter():
        with active_mesh(mesh), options(**opts):
            yield
    return enter


def batch_mesh_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over.  Normally the pure-DP
    axes; with the ``dp_all`` option every mesh axis acts data-parallel."""
    names = tuple(mesh.mesh_dim_names or ())
    if get_option("dp_all"):
        return names
    return tuple(a for a in ("pod", "data") if a in names)


def _mesh_spec(mesh, axes) -> P:
    """The partition spec of logical axis names on ``mesh``: ``"batch"``
    maps to the mesh's data-parallel axes, a mesh axis name maps to
    itself, anything else (``None``) to a replicated dim.  A mesh axis
    shards one dim at most: the first that names it (with ``dp_all``
    "batch" names them all)."""
    names = tuple(mesh.mesh_dim_names or ())
    used: set = set()
    spec = []
    for a in axes:
        cand = batch_mesh_axes(mesh) if a == "batch" else (a,)
        got = tuple(c for c in cand if c in names and c not in used)
        used.update(got)
        spec.append(got if got else None)
    return P(*spec)


def _placements(mesh, axes) -> tuple:
    return Sharding(mesh, _mesh_spec(mesh, axes)).placements


def _need_dtensor(x, what: str):
    if not isinstance(x, DTensor):
        raise TypeError(
            f"{what} under an active mesh needs a DTensor, got "
            f"{type(x).__name__}: place the step's inputs with "
            f"dist.sharding.distribute")


def constrain(x, *axes):
    """Sharding constraint by logical axis name per tensor dim.

    ``"batch"`` maps to the mesh's data-parallel axes, a mesh axis name
    maps to itself, anything else (``None``) leaves the dim replicated.
    Returns ``x`` itself without an active mesh, as the reference does.
    Under one, ``x`` must be a DTensor (a sharded step's inputs come in
    as DTensors, and so does everything computed from them); it is
    redistributed to those placements, and so is its gradient, as
    ``with_sharding_constraint`` constrains the cotangent too (DTensor's
    own ``redistribute`` lays a gradient out as its input was, which
    leaves a partial sum partial and lets the products before it run
    whole).  A plain tensor raises ``TypeError``.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    _need_dtensor(x, f"constrain{axes!r}")
    return _Constrain.apply(x, mesh, _placements(mesh, axes))


class _Constrain(torch.autograd.Function):
    """``redistribute`` forward, and backward to the same placements."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def gathered(tree):
    """The weights of ``tree`` (a dict of tensors, nested or not, or one
    tensor) whole over the mesh axes the batch is split over: FSDP's
    all-gather ahead of the products, whose gradient is reduce-scattered
    back.  A tensor dim that is also split over another mesh axis (the
    ``tp2d`` layout) keeps its layout.  Without a mesh ``tree`` itself.

    Each product then meets a weight laid out for tensor parallelism
    only.  Left to DTensor, a product whose weight is also split over
    the batch's axes is laid out by its release's choice (torch 2.11 and
    2.13 split the MoE experts' products differently)."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    _need_dtensor(tree, "gathered")
    names = tuple(mesh.mesh_dim_names)
    baxes = batch_mesh_axes(mesh)
    pl = tuple(tree.placements)
    keep = {p.dim for m, p in enumerate(pl)
            if isinstance(p, Shard) and names[m] not in baxes}
    want = tuple(Replicate() if isinstance(p, Shard) and names[m] in baxes
                 and p.dim not in keep else p for m, p in enumerate(pl))
    return tree if want == pl else tree.redistribute(mesh, want)


def replicated(t, like):
    """``t``, a tensor every rank computes alike (an ``arange``, a mask,
    a rotary table), as a replicated DTensor on ``like``'s mesh when
    ``like`` is a DTensor; otherwise ``t`` itself.  Nothing moves."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def along(t, x, dim: int):
    """``t``, a 1-D tensor every rank computes alike of ``x.shape[dim]``
    entries (an ``arange`` over that dim), laid out as ``x``'s ``dim``
    is when ``x`` is a DTensor: sharded where that dim is, whole
    elsewhere.  Each rank slices its part; nothing moves.  Without a
    DTensor ``t`` itself."""
    if not isinstance(x, DTensor):
        return t
    d = dim % x.ndim
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == d else Replicate()
          for p in x.placements]
    return replicated(t, x).redistribute(x.device_mesh, pl)


def local_apply(fn, args, in_axes, out_axes):
    """``fn(*args)``; under an active mesh, ``fn`` runs on each rank's
    local shards (``local_map``'s contract, written out here: the
    releases of torch this runs on differ in how ``local_map`` behaves
    when activation checkpointing recomputes it).

    ``in_axes`` gives, per argument, the logical axis names of the layout
    ``fn`` needs (as ``constrain`` takes them; ``None`` for an argument
    that is not a tensor): each DTensor argument is redistributed to it
    first.  ``out_axes`` gives the layout of each output (a list for
    several outputs).  ``fn`` must compute on those shards what it
    computes on the whole: a dim sharded on the way in is one ``fn``
    treats independently, as a batch or a head.  Under a mesh every
    tensor argument must be a DTensor; a plain one raises ``TypeError``
    rather than pass through with its global shape, and a dim its layout
    splits unevenly raises ``ValueError`` (the outputs' global shapes are
    their local ones times the ways each dim is split).

    Gradients: an argument whole over a mesh dim that another argument
    or an output is split over (a weight beside a batch shard; heads
    gathered to compute a rank's block of an output) gets, on each rank,
    the part of its gradient that rank's shard gives: its gradient is
    ``Partial`` over that dim, summed where it is laid out again.
    """
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    name = getattr(fn, "__name__", fn)
    ins = tuple(None if ax is None else _placements(mesh, ax)
                for ax in in_axes)
    outs = [_placements(mesh, ax) for ax in
            (out_axes if isinstance(out_axes, list) else [out_axes])]
    split = [any(isinstance(pl[m], Shard)
                 for pl in (*ins, *outs) if pl is not None)
             for m in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, ins):
        if pl is None:
            local.append(a)
            continue
        _need_dtensor(a, f"local_apply({name})")
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        # the outputs are laid out from equal local shards
        require_even(a.shape, mesh, pl, f"local_apply({name})")
        t = a.to_local(grad_placements=tuple(
            Partial() if split[m] and isinstance(p, Replicate) else p
            for m, p in enumerate(pl)))
        local.append(t.wait() if isinstance(t, AsyncCollectiveTensor)
                     else t)
    out = fn(*local)
    if isinstance(out_axes, list):
        return tuple(DTensor.from_local(o, mesh, _placements(mesh, ax),
                                        run_check=False)
                     for o, ax in zip(out, out_axes, strict=True))
    return DTensor.from_local(out, mesh, _placements(mesh, out_axes),
                              run_check=False)


def exchange(t):
    """All-to-all of a LOCAL tensor (inside ``local_apply``'s ``fn``)
    over the mesh axes the batch is split over, whose ``n`` ranks are
    numbered as a batch-split dim numbers its shards (the first axis
    major).  ``t``'s leading dim is ``n`` blocks: block ``i`` goes to
    batch rank ``i``; the result's block ``j`` is what batch rank ``j``
    sent this rank.  Over several axes it is one all-to-all an axis,
    which routes every block to the same place.  Its gradient is the
    same exchange of the gradient.  Without a mesh, or with one batch
    rank, ``t`` itself.

    DTensor's own all-to-all (a ``Shard(i)`` to ``Shard(j)``
    redistribution) moves the parts of one tensor that every rank holds
    a slice of; this moves what each rank packed for each other one, as
    a token-to-expert dispatch needs."""
    mesh = current_mesh()
    if mesh is None:
        return t
    groups = [mesh.get_group(a) for a in batch_mesh_axes(mesh)]
    groups = [g for g in groups if g.size() > 1]
    return _Exchange.apply(t, tuple(groups)) if groups else t


def reduce_scatter(t, axis: str, dim: int):
    """Reduce-scatter of a LOCAL tensor (inside ``local_apply``'s ``fn``)
    over mesh axis ``axis``: the sum of every rank's ``t``, of which this
    rank keeps its block of ``dim`` (split evenly, in rank order).  Its
    gradient is the all-gather of the gradient.  For a rank's part of a
    whole tensor, zero elsewhere, this lays the parts out as an even
    shard.  Without a mesh ``t`` itself."""
    mesh = current_mesh()
    if mesh is None:
        return t
    return _ReduceScatter.apply(t, mesh.get_group(axis), dim)


def _along_dim0(op, t, dim: int, group):
    """``op`` (a functional collective along dim 0: the group's blocks
    stacked there) applied along ``dim`` of ``t``."""
    n = group.size()
    x = t.movedim(dim, 0).contiguous()
    y = funcol.wait_tensor(op(x, n, group.group_name))
    return y.movedim(0, dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _along_dim0(
            lambda x, n, g: torch.ops._c10d_functional.reduce_scatter_tensor(
                x, "sum", n, g), t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _along_dim0(torch.ops._c10d_functional.all_gather_into_tensor,
                           grad, ctx.dim, ctx.group), None, None


def _all_to_all(t, groups):
    x = t.reshape(*(g.size() for g in groups), *t.shape[1:])
    for m, g in enumerate(groups):
        x = x.movedim(m, 0).contiguous()
        x = funcol.wait_tensor(funcol.all_to_all_single(x, None, None, g))
        x = x.movedim(0, m)
    return x.reshape(t.shape)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_to_all(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.groups), None


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
