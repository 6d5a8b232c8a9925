"""Logical-axis -> mesh-axis assignment (``repro.dist.sharding``'
counterpart), on ``DeviceMesh`` and DTensor placements.

Every parameter carries a tuple of LOGICAL dim names (see models/layers.py
and the ``axes`` pytree from ``lm.init_params``).  ``_spec_for`` maps one
such tuple to a partition spec ``P`` under a ``ShardingRules`` policy,
with the reference's rules and entries:

* tensor parallelism: the highest-priority TP-eligible dim ("ffn", head
  projections, "ssm_inner", "vocab") divisible by ``|model|`` is sharded
  over ``model`` (vocab-parallel embedding/head included);
* FSDP: the "embed" dim of non-vocab tensors is sharded over ``data``
  when divisible (ZeRO-3 style weight sharding);
* structural dims ("layers", "groups", "experts", None) are never sharded
  here;
* anything indivisible replicates.

A ``Sharding(mesh, spec)`` stands where the reference has a
``NamedSharding``; its ``placements`` are the DTensor placements of the
spec, one per mesh dimension, and ``distribute`` lays a tree out by them.
"""

from __future__ import annotations

import dataclasses

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

# TP-eligible logical dims, in assignment priority order.
_TP_PRIORITY = ("ffn", "heads_flat", "kv_flat", "ssm_inner", "vocab")
_HEADISH = ("heads_flat", "kv_flat")
# dims FSDP may claim (weight sharding over the data axis)
_FSDP_DIMS = ("embed",)


class P(tuple):
    """A partition spec: per tensor dim, ``None`` (replicated), a mesh
    axis name, or a tuple of mesh axis names (sharded over them jointly,
    the first one major) -- the entries of ``jax.sharding.PartitionSpec``,
    which also stores a one-name tuple as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Policy knobs (the dry-run's hillclimb variants flip these)."""
    fsdp: bool = True          # shard "embed" of non-vocab weights over data
    zero1: bool = True         # optimizer moments sharded like params
    heads_ok: bool = True      # head dims divisible by |model| -> TP on heads
    tp2d: bool = False         # TP dim over (data, model) jointly, no FSDP
    kv_seq_model: bool = False  # serve: shard KV-cache seq dim over model
    dp_only: bool = False      # pure DP: no weight sharding at all


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec laid over a mesh (``NamedSharding``'s counterpart)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dimension: ``Shard(d)`` where
        tensor dim ``d`` names that mesh axis, else ``Replicate()``."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            for a in (entry,) if isinstance(entry, str) else entry:
                out[names.index(a)] = Shard(d)
        return tuple(out)


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec_for(axes: tuple, shape: tuple, mesh, rules: ShardingRules) -> P:
    """Partition spec for one tensor from its logical dim names + shape."""
    sizes = _axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    spec: list = [None] * len(axes)
    if rules.dp_only:
        return P(*spec)
    # --- tensor parallelism ---
    tp_i = -1
    for name in _TP_PRIORITY:
        if name in _HEADISH and not rules.heads_ok:
            continue
        for i, a in enumerate(axes):
            if a == name and model > 1 and shape[i] % model == 0:
                tp_i = i
                break
        if tp_i >= 0:
            break
    if tp_i >= 0:
        if rules.tp2d and data > 1 and shape[tp_i] % (model * data) == 0:
            spec[tp_i] = ("data", "model")
            return P(*spec)          # data axis consumed; no FSDP on top
        spec[tp_i] = "model"
    # --- FSDP (weight sharding over data); vocab tensors excluded ---
    if rules.fsdp and "vocab" not in axes:
        for i, a in enumerate(axes):
            if (a in _FSDP_DIMS and spec[i] is None and data > 1
                    and shape[i] % data == 0):
                spec[i] = "data"
                break
    return P(*spec)


def rules_for(cfg, mesh, shape=None, *, fsdp: bool = True) -> ShardingRules:
    """Default ruleset for an arch on a mesh: TP over head dims only when
    the flattened head projections divide the model axis."""
    model = _axis_sizes(mesh).get("model", 1)
    hd = getattr(cfg, "head_dim", 0) or 0
    nh = (getattr(cfg, "n_heads", 0) or 0) * hd
    nkv = (getattr(cfg, "n_kv_heads", 0) or 0) * hd
    heads_ok = model <= 1 or (nh % model == 0 and nkv % model == 0
                              and nkv >= model)
    return ShardingRules(fsdp=fsdp, heads_ok=heads_ok)


def _map(f, axes, shapes):
    """``f(axes_leaf, shape_leaf)`` over the params tree (nested dicts
    whose leaves are axes tuples and tensors)."""
    if isinstance(axes, dict):
        return {k: _map(f, axes[k], shapes[k]) for k in axes}
    return f(axes, shapes)


def make_param_specs(axes, shapes, mesh, rules: ShardingRules):
    """``Sharding`` tree mirroring the params tree (``shapes``: tensors,
    meta tensors or anything with a ``.shape``)."""
    return _map(lambda ax, sh: Sharding(mesh, _spec_for(ax, tuple(sh.shape),
                                                        mesh, rules)),
                axes, shapes)


def moment_specs(axes, shapes, mesh, rules: ShardingRules):
    """AdamW moment shardings: like params (ZeRO-1 keeps moments sharded
    even when the weights themselves replicate)."""
    if not (rules.zero1 or rules.fsdp):
        return _map(lambda ax, sh: Sharding(mesh, P(*([None] * len(sh.shape)))),
                    axes, shapes)
    return make_param_specs(axes, shapes, mesh, rules)


def make_batch_specs(shapes: dict, mesh, *, all_axes: bool = False) -> dict:
    """Batch-input shardings: leading batch dim over the DP axes.  mrope
    ``positions`` carries a leading (3,) structural dim; the batch dim is
    its second."""
    names = tuple(mesh.mesh_dim_names)
    cand = names if all_axes else ("pod", "data")
    baxes = tuple(a for a in cand if a in names)
    out = {}
    for name, sds in shapes.items():
        nd = len(sds.shape)
        if name == "positions":
            spec = P(None, baxes if baxes else None, *([None] * (nd - 2)))
        else:
            spec = P(baxes if baxes else None, *([None] * (nd - 1)))
        out[name] = Sharding(mesh, spec)
    return out


def make_cache_specs(shapes: dict, mesh, rules: ShardingRules,
                     global_batch: int) -> dict:
    """Decode-cache shardings: batch dim over the DP axes; with
    ``kv_seq_model`` the KV seq dim additionally shards over model
    (sequence-sharded cache, decode-side)."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    sizes = _axis_sizes(mesh)
    out = {}
    for name, sds in shapes.items():
        spec: list = [None] * len(sds.shape)
        b_i = -1
        for i, d in enumerate(sds.shape):
            if d == global_batch:
                spec[i] = baxes if baxes else None
                b_i = i
                break
        if (rules.kv_seq_model and name in ("k", "v") and b_i >= 0
                and b_i + 1 < len(sds.shape)
                and sds.shape[b_i + 1] % sizes.get("model", 1) == 0):
            spec[b_i + 1] = "model"
        out[name] = Sharding(mesh, P(*spec))
    return out


def require_even(shape, mesh, placements, what: str) -> None:
    """Raise ``ValueError`` unless every dim ``placements`` split is a
    multiple of the mesh axes splitting it: an uneven shard is an error,
    as an indivisible sharding of a ``jit`` argument is in the
    reference."""
    ways: dict = {}
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.shape[m]
    for d, n in ways.items():
        if shape[d] % n:
            raise ValueError(
                f"{what}: dim {d} of shape {tuple(shape)} is split {n} "
                f"ways by {tuple(placements)}, which does not divide it")


def distribute(tree, specs):
    """Lay out a params, moments, cache or batch tree (nested dicts of
    tensors) as DTensors by a ``Sharding`` tree of the same structure.
    Every rank passes the same global values; each keeps its shard.  A
    dim the mesh does not divide raises ``ValueError``."""
    if isinstance(tree, dict):
        return {k: distribute(tree[k], specs[k]) for k in tree}
    require_even(tree.shape, specs.mesh, specs.placements,
                 f"distribute(spec {specs.spec!r})")
    return distribute_tensor(tree, specs.mesh, specs.placements)
