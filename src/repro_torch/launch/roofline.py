"""Roofline terms of a dry-run cell (``repro.launch.roofline``'
counterpart), on the H100's numbers.

  compute term    = flops / peak_FLOP/s                (per chip)
  memory term     = analytical HBM bytes / HBM_bw      (per chip)
  collective term = collective_link_bytes / link_bw    (per chip)

The reference reads flops from XLA's cost analysis and parses the
collectives out of the compiled HLO text (``parse_collectives``, kept
here verbatim: it reads any HLO dump).  The port has no compiler step:
the dry run counts the flops of the local products each rank runs and
records the collectives the step issues with ``CollectiveRecorder``,
with the same ring-model link-traffic factors:

  all-gather       (n-1)/n x output bytes
  reduce-scatter   (n-1)/n x output bytes
  all-reduce       2(n-1)/n x bytes
  all-to-all       (n-1)/n x bytes
  collective-permute  1.0 x bytes

Hardware model: one NVIDIA H100 SXM, datasheet values (the card the port
runs on reports "NVIDIA H100 80GB HBM3, 700.00 W" to ``nvidia-smi
--query-gpu=name,power.limit``): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
450 GB/s a direction over NVLink 4.  NVLink joins the 8 GPUs of one
node; a 16-wide model axis crosses the node boundary, where the link is
InfiniBand (50 GB/s a direction for one 400 Gb/s NIC), so ``LINK_BW``
is the best case for such a mesh.
"""

from __future__ import annotations

import dataclasses
import re

from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[^\]]*\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_GROUPS_RE = re.compile(r"replica_groups=\{(\{[^}]*\})")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))      # [n_groups, group_size]
    m = _GROUPS_RE.search(line)
    if m:
        return m.group(1).count(",") + 1
    return 2


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict
    link_bytes: float               # ring-model per-chip link traffic

    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: dict = {}
    by_kind: dict = {}
    link = 0.0
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue                # the -start op carries the payload
        kind = m.group(2)
        nbytes = _shape_bytes(m.group(1))
        n = max(_group_size(line), 2)
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0) + nbytes
        frac = (n - 1) / n
        if kind == "all-reduce":
            link += 2 * frac * nbytes
        elif kind == "collective-permute":
            link += nbytes
        else:
            link += frac * nbytes
    return CollectiveStats(counts, by_kind, link)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    coll: CollectiveStats
    model_flops_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_chip / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the dominant-term-limited execution achieves on
        USEFUL model flops: (model_flops/peak) / bound_time."""
        ideal = self.model_flops_per_chip / PEAK_FLOPS
        return ideal / max(self.bound_s, 1e-30)


def analytical_memory_bytes(cfg, shape, n_chips: int,
                            kv_extra_shard: int = 1,
                            model_axis: int = 16) -> float:
    """Per-chip HBM traffic model (the reference's, fusion-realistic),
    used for the memory roofline term.  ``model_axis`` is the mesh's
    model-axis size (16 on the production meshes, where the result is
    the reference's to the bit).

    Components: weight streams (TP-sharded, x3 for fwd/bwd/remat-fwd),
    optimizer state read+write (fp32, FSDP-sharded), activation streams
    per layer, flash-attention KV re-streaming (S^2/q_block), KV-cache /
    SSM-state read for decode, and logits traffic.
    """
    # the model axis (the reference hard-codes 16, and divides by zero on
    # fewer than 16 chips); a mesh smaller than it is all model axis
    m = min(model_axis, n_chips)
    dp = n_chips // m
    d = cfg.d_model
    L = cfg.n_layers
    S = shape.seq_len
    B = shape.global_batch
    dt = 2.0                                 # bf16
    P = cfg.param_count()

    if shape.kind == "decode":
        tokens_chip = max(B // dp, 1)
        w_bytes = P * dt / m                  # every weight read once
        cache = 0.0
        if cfg.family in ("ssm", "hybrid"):
            d_in = cfg.ssm_expand * d
            H = d_in // cfg.ssm_headdim
            n_attn = (L // cfg.shared_attn_every
                      if cfg.family == "hybrid" else 0)
            n_ssm = L if cfg.family == "ssm" else L
            cache += n_ssm * max(B, 1) * H * cfg.ssm_state * \
                cfg.ssm_headdim * 4 / n_chips * 2      # state r+w fp32
            if n_attn:
                cache += n_attn * B * S * cfg.n_kv_heads * cfg.head_dim \
                    * dt * 2 / n_chips                 # KV read + write
        else:
            kv_shard = m if cfg.n_kv_heads % m == 0 else kv_extra_shard
            cache += L * B * S * cfg.n_kv_heads * cfg.head_dim * dt \
                / max(dp, 1) / kv_shard
        act = tokens_chip * L * 12 * d * dt
        return w_bytes + cache + act

    tokens_chip = B * S // dp
    mult = 3.0 if shape.kind == "train" else 1.0       # fwd+bwd+remat-fwd
    w_bytes = P * dt / m * mult
    if shape.kind == "train":
        w_bytes += P / n_chips * (4 + 4) * 4           # adam mu/nu rw fp32
    # per-layer activation stream (bf16), model-sharded inner dims
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        layer_act = (8 * d + 10 * d_in / m +
                     4 * cfg.ssm_state * cfg.ssm_groups) * dt
    elif cfg.moe_experts:
        layer_act = (8 * d + 6 * cfg.moe_top_k * cfg.d_ff / m + 2 * d +
                     4 * cfg.n_heads * cfg.head_dim / m) * dt
    else:
        layer_act = (8 * d + 6 * cfg.d_ff / m +
                     4 * cfg.n_heads * cfg.head_dim / m) * dt
    act = tokens_chip * L * layer_act * mult
    # flash attention KV re-streaming: (S / q_block) passes over KV
    if cfg.n_heads:
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        kv_shard = m if cfg.n_kv_heads % m == 0 else 1
        attn = (B // dp) * (S / 512.0) * S * kv_dim * dt / kv_shard * \
            L * mult
    else:
        attn = 0.0
    # logits (fp32) fwd+bwd
    head = tokens_chip * cfg.vocab / m * 4 * (2 if shape.kind == "train"
                                              else 0.001)
    return w_bytes + act + attn + head


def model_flops(cfg, shape, n_chips: int) -> float:
    """6·N_active·D (train) or 2·N_active·D (fwd-only) per step, global."""
    act = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * act * tokens


def roofline_from(cost: dict, hlo_text: str, cfg, shape,
                  n_chips: int) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    bts = float(cost.get("bytes accessed", 0.0))
    coll = parse_collectives(hlo_text)
    mf = model_flops(cfg, shape, n_chips) / n_chips
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bts / HBM_BW,
        collective_s=coll.link_bytes / LINK_BW,
        flops=flops, bytes_hbm=bts, coll=coll,
        model_flops_per_chip=mf,
    )


#: collective ops a step may issue -> the reference's HLO kind names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor",)


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives a step issues, as ``parse_collectives``
    reads them from HLO: per kind, the count and the bytes of the op's
    result on this rank, and the ring-model link bytes with the group's
    size.  It sees the ops below DTensor (it steps aside for DTensor
    arguments, so DTensor first turns a redistribution into its
    collectives).  ``mesh`` names the groups an ``all_reduce`` (which
    carries no size) may run on.  An op of a collective namespace that it
    does not know raises."""

    def __init__(self, mesh):
        super().__init__()
        self._sizes = {mesh.get_group(i).group_name: mesh.get_group(i).size()
                       for i in range(mesh.ndim)}
        self.counts: dict = {}
        self.bytes_by_kind: dict = {}
        self.link = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace in _COLL_NAMESPACES:
            name = func._opname
            if name not in _NOT_COLLECTIVES:
                if name not in _KINDS:
                    raise NotImplementedError(
                        f"CollectiveRecorder: unknown collective {func}")
                self._record(_KINDS[name], out,
                             kwargs.get("group_name", args[-1]))
        return out

    def _record(self, kind: str, out, group_name: str):
        outs = out if isinstance(out, (list, tuple)) else [out]
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        n = max(self._sizes[group_name], 2)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        frac = (n - 1) / n
        self.link += 2 * frac * nbytes if kind == "all-reduce" \
            else frac * nbytes

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.bytes_by_kind),
                               self.link)
