"""Multi-pod dry run: run every (arch x shape x mesh) cell once on a
placeholder world and count what one chip does (``repro.launch.dryrun``'
counterpart).

The reference forces 512 placeholder XLA host devices, lowers and
compiles each step with explicit shardings, and reads XLA's memory and
cost analyses and the collectives of the HLO text.  PyTorch has no
compiler step; it has what those analyses measure.  For every cell the
dry run:

  1. opens a placeholder world (``mesh.placeholder_world``: a fake
     process group of 256 or 512 ranks in this process; this process is
     rank 0) and builds the production ``DeviceMesh`` on it,
  2. makes the state, batch and cache as fake tensors (``FakeTensorMode``:
     shapes and dtypes, no memory) and lays them out as DTensors by the
     specs of ``dist/sharding.py``,
  3. runs the step once, eagerly -- a sharding DTensor cannot propagate,
     or a shape mismatch, is a FAILURE of the cell, as a failed compile
     is in the reference --
  4. records what rank 0 did: the flops of the products it ran on its own
     shards, the collectives it issued (``roofline.CollectiveRecorder``),
     the bytes of its shards of the arguments and the peak of the live
     bytes of its local tensors, and writes them with the roofline terms
     to one JSON file a cell.

No probes: XLA's cost analysis counts a loop body once, so the reference
recompiles depth-1 and depth-2 variants and extrapolates.  Eager
counting sees every layer and every attention block, so the counts here
are the full step's as they stand (``"corrected_by_probes": false``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k [--multi-pod]           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --device cpu

The fake tensors live on ``--device`` (the card by default; without one
this exits 2).  Nothing is allocated there and nothing runs there.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import pathlib
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..api import resolve_device
from ..configs import (ARCHS, SHAPES, ShapeConfig, get_arch,
                       shape_applicable, smoke_config)
from ..dist.api import active_mesh, options
from ..dist.sharding import (P, Sharding, distribute, make_batch_specs,
                             make_cache_specs, make_param_specs,
                             moment_specs, rules_for)
from ..optim.adamw import tree_map
from . import roofline as rl
from .mesh import (make_production_mesh, make_smoke_mesh, mesh_axis_sizes,
                   placeholder_world)
from .specs import (abstract_cache, abstract_opt_state, abstract_params,
                    decode_input_specs, input_specs)
from .steps import make_decode_step, make_prefill_step, make_train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

# serve-mode FSDP threshold: per-chip weight bytes above which weights are
# sharded over `data` too
SERVE_FSDP_BYTES = 8e9

NO_PROBES = ("eager counting sees every layer and every attention block; "
             "nothing is counted once for a loop")


def pad_vocab(cfg):
    """Pad vocab to a multiple of 16 for model-axis sharding (loss masks
    the padded columns via cfg.vocab_real)."""
    v = cfg.vocab
    if v % 16 == 0:
        return cfg
    vp = -(-v // 16) * 16
    return dataclasses.replace(cfg, vocab=vp, vocab_real=v)


def layers_scaled(cfg, k: int):
    """Depth-k variant of ``cfg`` (hybrid: k groups), the reference's
    probe depth; the port runs no probes, and keeps it for whoever cuts a
    cell's depth."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.shared_attn_every * k)
    return dataclasses.replace(cfg, n_layers=k)


def depth_units(cfg) -> float:
    if cfg.family == "hybrid":
        return cfg.n_layers / cfg.shared_attn_every
    return float(cfg.n_layers)


# ---------------------------------------------------------------------
# what one rank does: local flops and live bytes
# ---------------------------------------------------------------------

#: the code DTensor runs to propagate a sharding; it runs ops on fake
#: tensors of the GLOBAL shapes, which no rank computes
_PROPAGATION_CODE = frozenset(
    inspect.unwrap(getattr(ShardingPropagator, n)).__code__
    for n in ("propagate_op_sharding_non_cached",
              "_propagate_tensor_meta_non_cached")
    if hasattr(ShardingPropagator, n))
if not _PROPAGATION_CODE:
    raise ImportError("DTensor's ShardingPropagator has none of the "
                      "methods the dry run steps over")


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the Python stack (a
    dispatch from autograd's engine may have no Python caller at all)."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code in _PROPAGATION_CODE:
            return True
        f = f.f_back
    return False


class LocalCounter(TorchDispatchMode):
    """Counts what this rank computes: it steps aside for DTensor
    arguments (DTensor then runs each op on the local shards, which this
    mode sees) and for the ops DTensor runs to propagate a sharding.

    * ``flops``: ``torch.utils.flop_counter``'s count of every local
      product (``mm``, ``bmm``, ``addmm``, ...), forward and backward.
    * ``peak_bytes``: the most bytes of local storage live at once: the
      ``base_bytes`` given (the shards of the arguments), plus every
      storage a local op makes, until it is freed.
    """

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.flops = 0
        self.live = base_bytes
        self.peak_bytes = base_bytes
        self._seen = WeakIdKeyDictionary()

    def _free(self, nbytes: int):
        self.live -= nbytes

    def _track(self, t):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, out_val=out, **kwargs)
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors of ``tree``."""
    local = [t.to_local() if isinstance(t, DTensor) else t
             for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in local)


def _fake(tree, dev):
    """Fake tensors (inside a ``FakeTensorMode``) of ``tree``'s shapes
    and dtypes on ``dev``."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=dev), tree)


@dataclasses.dataclass
class CellRun:
    run_s: float
    flops: float
    coll: rl.CollectiveStats
    argument_bytes: int
    output_bytes: int
    peak_bytes: int


def _run_cell(cfg, shape, mesh, *, fsdp_train: bool = True,
              q_block: int = 512, kv_block: int = 512,
              variant: dict | None = None) -> CellRun:
    """Run one step once on fake tensors laid out over ``mesh`` (a mesh
    of a placeholder world) and count what rank 0 did.

    ``variant`` carries hillclimb levers: rules fields (tp2d,
    kv_seq_model, dp_only, fsdp) and api options (seq_parallel, moe_ep,
    moe_gather_w, moe_groups, dp_all).
    """
    variant = dict(variant or {})
    api_opts = {k: variant.pop(k) for k in
                ("seq_parallel", "moe_ep", "moe_gather_w", "moe_groups",
                 "dp_all") if k in variant}
    rules = rules_for(cfg, mesh, shape, fsdp=variant.pop("fsdp", fsdp_train))
    if variant:
        rules = dataclasses.replace(rules, **variant)
    pshapes, axes = abstract_params(cfg)
    dev = torch.device(mesh.device_type)
    with FakeTensorMode(), active_mesh(mesh), options(**api_opts):
        if shape.kind == "train":
            ms = moment_specs(axes, pshapes, mesh, rules)
            specs = {"params": make_param_specs(axes, pshapes, mesh, rules),
                     "opt": {"step": Sharding(mesh, P()), "mu": ms,
                             "nu": ms}}
            state = {"params": pshapes, "opt": abstract_opt_state(pshapes)}
            bshapes = input_specs(cfg, shape)
            bspecs = make_batch_specs(bshapes, mesh, all_axes=rules.dp_only)
            step = make_train_step(cfg, q_block=q_block, kv_block=kv_block)
            args = (distribute(_fake(state, dev), specs),
                    distribute(_fake(bshapes, dev), bspecs))
        else:
            rules_serve = dataclasses.replace(
                rules, fsdp=_serve_fsdp(cfg, mesh), zero1=False)
            params = distribute(_fake(pshapes, dev), make_param_specs(
                axes, pshapes, mesh, rules_serve))
            if shape.kind == "prefill":
                bshapes = input_specs(cfg, shape)
                step = make_prefill_step(cfg, q_block=q_block,
                                         kv_block=kv_block)
                args = (params, distribute(_fake(bshapes, dev),
                                           make_batch_specs(bshapes, mesh)))
            else:  # decode: one token at the last slot of the cache
                cshapes = abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len)
                bshapes = decode_input_specs(cfg, shape)
                step = make_decode_step(cfg)
                args = (params,
                        distribute(_fake(cshapes, dev), make_cache_specs(
                            cshapes, mesh, rules_serve, shape.global_batch)),
                        distribute(_fake(bshapes, dev),
                                   make_batch_specs(bshapes, mesh)),
                        shape.seq_len - 1)
        arg_bytes = _local_bytes(args)
        rec = rl.CollectiveRecorder(mesh)
        counter = LocalCounter(arg_bytes)
        t0 = time.perf_counter()
        with rec, counter:
            out = step(*args)
        run_s = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    return CellRun(run_s, float(counter.flops), rec.stats(), arg_bytes,
                   out_bytes, counter.peak_bytes)


def _record(cfg, shape, mesh, run: CellRun, variant) -> dict:
    """The reference's record keys, where their meaning holds."""
    n_chips = mesh.size()
    sizes = mesh_axis_sizes(mesh)
    roof = rl.roofline_from({"flops": run.flops}, "", cfg, shape, n_chips)
    roof.coll = run.coll
    roof.collective_s = run.coll.link_bytes / rl.LINK_BW
    kv_extra = 16 if (variant or {}).get("kv_seq_model") else 1
    mem_bytes = rl.analytical_memory_bytes(
        cfg, shape, n_chips, kv_extra_shard=kv_extra,
        model_axis=sizes.get("model", 1))
    roof.memory_s = mem_bytes / rl.HBM_BW
    return {
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_chips": n_chips,
        "device_type": mesh.device_type,
        "kind": shape.kind,
        "run_s": run.run_s,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {
            "argument_bytes": run.argument_bytes,
            "output_bytes": run.output_bytes,
            "temp_bytes": run.peak_bytes - run.argument_bytes,
            "peak_bytes": run.peak_bytes,
            "peak_source": "explicit count of rank 0's live local storages",
        },
        "cost": {
            "flops": run.flops,
            "flops_source": "rank 0's local products (torch flop formulas)",
            "corrected_by_probes": False,
            "why_no_probes": NO_PROBES,
        },
        "collectives": {
            "counts": run.coll.counts,
            "bytes_by_kind": {k: float(v)
                              for k, v in run.coll.bytes_by_kind.items()},
            "link_bytes": float(run.coll.link_bytes),
        },
        "roofline": {
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "memory_bytes_analytical": mem_bytes,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "model_flops_per_chip": roof.model_flops_per_chip,
            "useful_flops_ratio": roof.useful_flops_ratio,
            "roofline_fraction": roof.roofline_fraction,
        },
        "hardware": {"peak_flops": rl.PEAK_FLOPS, "hbm_bw": rl.HBM_BW,
                     "link_bw": rl.LINK_BW,
                     "model": "NVIDIA H100 SXM datasheet"},
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               *, fsdp_train: bool = True, variant: dict | None = None,
               device="cuda", q_block: int = 512,
               kv_block: int = 512) -> dict:
    """One production cell on its placeholder world; the record.  The
    reference's ``probe`` switch has no counterpart: the counts here need
    no probes (``NO_PROBES``).  ``device`` is where the fake tensors live
    (the card by default; without one this raises)."""
    dev = resolve_device(device)
    cfg = pad_vocab(get_arch(arch))
    if variant and "remat_policy" in variant:
        variant = dict(variant)
        cfg = dataclasses.replace(cfg,
                                  remat_policy=variant.pop("remat_policy"))
    shape = SHAPES[shape_name]
    with placeholder_world(512 if multi_pod else 256, dev.type):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        run = _run_cell(cfg, shape, mesh, fsdp_train=fsdp_train,
                        q_block=q_block, kv_block=kv_block, variant=variant)
        rec = {"arch": arch, "shape": shape_name}
        rec.update(_record(cfg, shape, mesh, run, variant))
    rec["q_block"], rec["kv_block"] = q_block, kv_block
    return rec


def _serve_fsdp(cfg, mesh) -> bool:
    sizes = mesh_axis_sizes(mesh)
    per_chip = cfg.param_count() * 2 / sizes.get("model", 1)
    return per_chip > SERVE_FSDP_BYTES


def cells(multi_pod: bool):
    for arch, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            if not shape_applicable(cfg, shape):
                continue
            yield arch, sname, multi_pod


# ---------------------------------------------------------------------
# smoke sweep: reduced configs on a 2x2 mesh
# ---------------------------------------------------------------------

SMOKE_SHAPES = {
    "train_smoke": ShapeConfig("train_smoke", 128, 8, "train"),
    "prefill_smoke": ShapeConfig("prefill_smoke", 128, 4, "prefill"),
    "decode_smoke": ShapeConfig("decode_smoke", 128, 8, "decode"),
}
# one arch per family (dense / MoE / SSM) x the three step kinds
SMOKE_CELLS = [
    ("qwen1.5-0.5b", "train_smoke"),
    ("qwen1.5-0.5b", "prefill_smoke"),
    ("qwen1.5-0.5b", "decode_smoke"),
    ("dbrx-132b", "train_smoke"),
    ("mamba2-130m", "decode_smoke"),
]


def run_smoke(out_dir: pathlib.Path, *, device="cuda",
              records: list | None = None) -> list[tuple[str, str]]:
    """Every smoke (arch x shape) on the 2x2 mesh of a 4-rank placeholder
    world, with the SAME sharding plumbing as the production sweep: a
    sharding DTensor cannot propagate fails here in seconds.  Writes one
    record a cell (also appended to ``records``); returns the failures.
    """
    dev = resolve_device(device)
    failures = []
    with placeholder_world(4, dev.type):
        mesh = make_smoke_mesh(dev.type)
        for arch, sname in SMOKE_CELLS:
            cfg = pad_vocab(smoke_config(arch))
            shape = SMOKE_SHAPES[sname]
            tag = f"smoke__{arch}__{sname}"
            try:
                run = _run_cell(cfg, shape, mesh, q_block=64, kv_block=64)
            except Exception as e:  # noqa: BLE001 - report, continue sweep
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e!r}", flush=True)
                continue
            rec = {"arch": arch, "shape": sname}
            rec.update(_record(cfg, shape, mesh, run, None))
            (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
            if records is not None:
                records.append(rec)
            print(f"OK   {tag:45s} run={run.run_s:6.2f}s "
                  f"flops/chip={run.flops:.4g} "
                  f"coll={rec['collectives']['counts']}", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized sweep: smoke configs on a 2x2 mesh")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors live: cuda (default) or cpu")
    ap.add_argument("--q-block", type=int, default=512,
                    help="attention's query and key block rows in the "
                         "production cells (the counts do not depend on "
                         "it; the run's time does)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.smoke:
        failures = run_smoke(out_dir, device=args.device)
        if failures:
            print(f"\n{len(failures)} FAILURES:")
            for t, e in failures:
                print(" ", t, e[:200])
            return 1
        print(f"\nall {len(SMOKE_CELLS)} smoke cells ran")
        return 0

    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, --all or --smoke")
    todo = list(cells(args.multi_pod)) if args.all else \
        [(args.arch, args.shape, args.multi_pod)]
    failures = []
    for arch, sname, mp in todo:
        tag = f"{arch}__{sname}__{'2x16x16' if mp else '16x16'}"
        try:
            rec = lower_cell(arch, sname, mp, device=args.device,
                             q_block=args.q_block, kv_block=args.q_block)
        except Exception as e:  # noqa: BLE001 - report, continue sweep
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)
            continue
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(f"OK   {tag:60s} run={rec['run_s']:6.1f}s "
              f"dom={r['dominant']:10s} "
              f"comp={r['compute_s']*1e3:8.2f}ms "
              f"mem={r['memory_s']*1e3:8.2f}ms "
              f"coll={r['collective_s']*1e3:8.2f}ms "
              f"frac={r['roofline_fraction']:.3f}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        return 1
    print(f"\nall {len(todo)} cells ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
