"""Elastic re-meshing: recover from node loss / grow into new capacity.

Strategy (checkpoint-restart elasticity — the production-standard design
for TPU pods, where the SPMD program shape is fixed at compile time):

1. the training loop checkpoints (atomically) at the failure signal;
2. ``plan_remesh`` picks the largest valid mesh for the surviving chips —
   the `model` axis is preserved (TP degree is a model-quality contract),
   the `data`/`pod` axes shrink to the largest divisor of the remaining
   chip count;
3. the launcher recompiles the step for the new mesh and restores the
   checkpoint: parameters are resharded automatically on load because the
   checkpoint stores unsharded logical arrays;
4. the global batch is either kept (grad-accumulation steps added) or
   scaled, per policy.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One worker's contiguous chunk range of a fixed-base-chunked run.

    ``start``/``stop`` index the global chunk ordinals of
    ``repro_torch.io.stream.plan_chunks`` (half-open).  Contiguity is
    load-bearing: the deterministic SAM merge is a plain concatenation in
    shard order, which equals the unsharded chunk order only because shard
    i's chunks all precede shard i+1's.
    """
    shard: int
    start: int
    stop: int

    @property
    def n_chunks(self) -> int:
        return self.stop - self.start


def plan_shards(n_reads_hint: int, workers: int, chunk_bases: int, *,
                n_chunks: int | None = None,
                read_len_hint: int = 101) -> list[ShardPlan]:
    """Alignment-shaped re-plan: split a chunked read set over workers.

    The fixed-base chunk decomposition (bwa ``-K``) is a property of the
    INPUT, not of this plan — so re-planning the same chunk ordinals over
    a different worker count (elastic shrink after a lost worker, or a
    retry of a failed shard's remaining range) never changes any chunk's
    content, only who aligns it.  Pass the exact ``n_chunks`` when known
    (``len(repro_torch.io.stream.plan_chunks(...))``); otherwise it is
    estimated from ``n_reads_hint * read_len_hint / chunk_bases``.

    Returns one contiguous, balanced ``ShardPlan`` per worker (at most
    ``min(workers, n_chunks)`` non-empty shards; remainder chunks go to
    the leading shards, matching the balanced-contiguous split).
    """
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if chunk_bases < 1:
        raise ValueError("chunk_bases must be >= 1")
    if n_chunks is None:
        if n_reads_hint < 0:
            raise ValueError("n_reads_hint must be >= 0")
        n_chunks = max(
            1, -(-n_reads_hint * max(read_len_hint, 1) // chunk_bases))
    n_shards = min(workers, n_chunks)
    plans: list[ShardPlan] = []
    base, rem = divmod(n_chunks, max(n_shards, 1))
    start = 0
    for s in range(n_shards):
        size = base + (1 if s < rem else 0)
        plans.append(ShardPlan(shard=s, start=start, stop=start + size))
        start += size
    return plans


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pods: int
    grad_accum: int          # extra accumulation to keep the global batch
    dropped_chips: int

    @property
    def n_chips(self):
        return self.data * self.model * self.pods


def plan_remesh(available_chips: int, *, model: int = 16,
                target_global_batch: int = 256,
                per_replica_batch: int = 1,
                keep_global_batch: bool = True) -> ElasticPlan:
    """Largest (pods x data x model) mesh fitting the surviving chips."""
    if available_chips < model:
        raise ValueError(
            f"cannot keep model axis {model} with {available_chips} chips")
    groups = available_chips // model            # candidate data*pod extent
    # prefer full pods of 16 data-rows when possible
    pods = max(groups // 16, 1) if groups >= 16 else 1
    data = groups // pods
    used = pods * data * model
    replicas = pods * data
    if keep_global_batch:
        per_step = replicas * per_replica_batch
        accum = max(1, -(-target_global_batch // max(per_step, 1)))
    else:
        accum = 1
    return ElasticPlan(data=data, model=model, pods=pods, grad_accum=accum,
                       dropped_chips=available_chips - used)
