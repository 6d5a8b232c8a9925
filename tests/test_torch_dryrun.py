"""The port's dry run and its sharded model on the CPU.

* ``placeholder_world`` leaves no process group behind and refuses to
  run over one that exists.
* ``CollectiveRecorder``: one hand-built ``redistribute`` a collective
  kind on a fake 2x2 mesh gives the stats ``parse_collectives`` reads
  from the same op written as an HLO line.
* The per-chip flops the dry run counts equal hand counts of their
  products: a one-layer smoke qwen1.5-0.5b prefill and its decode, the
  smoke dbrx-132b's train step (with its all-to-alls), the smoke
  mamba2-130m's prefill and decode, and the full-width production cell;
  a dim the mesh does not divide raises.
* ``run_smoke`` runs its 5 cells; ``python -m repro_torch.launch.dryrun
  --arch qwen1.5-0.5b --shape train_4k --device cpu`` writes one record.
* Sharded numerics, in one test: 4 gloo processes on a real 2x2 CPU
  mesh run the forward, loss and gradients of the smoke qwen1.5-0.5b,
  of dbrx-132b with the default dispatch and with ``moe_ep``, of
  mamba2-130m and of zamba2-7b (weights whole on every rank beside
  batch shards: their gradients are summed over the data axis), within
  1e-5 of the unsharded port in float32, with the same MoE keep masks; the
  unsharded port is held to the JAX reference within the 1e-4 of
  ``tests/test_torch_train_step.py``; and 3 decode steps of qwen1.5-0.5b,
  mamba2-130m and zamba2-7b with the cache sharded by batch, and the KV
  cache by sequence too, within 1e-5.

This module imports no JAX at its top: the 4 processes import it.
"""

import dataclasses
import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.launch import roofline as rroof
from repro_torch.configs import smoke_config
from repro_torch.dist.api import active_mesh, local_apply, read_shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh, placeholder_world
from repro_torch.launch.roofline import CollectiveRecorder
from repro_torch.models import lm

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --------------------------- placeholder world ---------------------------

def test_placeholder_world_leaves_nothing_and_refuses_to_nest():
    assert not dist.is_initialized()
    with placeholder_world(4, "cpu"):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        assert read_shard() == (0, 4)
        with pytest.raises(RuntimeError, match="already initialised"):
            with placeholder_world(4, "cpu"):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    assert read_shard() == (0, 1)
    with pytest.raises(ZeroDivisionError):
        with placeholder_world(2, "cpu"):
            1 / 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with placeholder_world(4, "cpu"):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert read_shard() == (0, 1)


# --------------------------- collective recorder ---------------------------

GROUPS = "replica_groups=[2,2]<=[4]"
REDISTRIBUTIONS = [
    # (from placements, local shape, to placements, HLO line of the op)
    ([Replicate(), Shard(0)], (4, 8), [Replicate(), Replicate()],
     f"%ag = f32[8,8]{{1,0}} all-gather(%x), {GROUPS}, dimensions={{0}}"),
    ([Replicate(), Partial()], (8, 8), [Replicate(), Shard(0)],
     f"%rs = f32[4,8]{{1,0}} reduce-scatter(%x), {GROUPS}, "
     f"dimensions={{0}}"),
    ([Replicate(), Partial()], (8, 8), [Replicate(), Replicate()],
     f"%ar = f32[8,8]{{1,0}} all-reduce(%x), {GROUPS}"),
    # Shard(0) -> Shard(1) over the model axis: an all-to-all on the card;
    # DTensor on a CPU mesh takes an all-gather and a chunk instead, so
    # this case issues the functional all-to-all itself
    ([Replicate(), Shard(0)], (4, 8), None,
     f"%a2a = f32[4,8]{{1,0}} all-to-all(%x), {GROUPS}, dimensions={{0}}"),
]


@pytest.mark.parametrize("case", range(len(REDISTRIBUTIONS)))
def test_collective_recorder_matches_hlo_parser(case):
    src, local, dst, hlo = REDISTRIBUTIONS[case]
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(local), mesh, src,
                                   run_check=False)
            rec = CollectiveRecorder(mesh)
            with rec:
                if dst is None:
                    funcol.all_to_all_single(x.to_local(), None, None,
                                             mesh.get_group("model"))
                else:
                    y = x.redistribute(mesh, dst)
            assert dst is None or tuple(y.placements) == tuple(dst)
    got, want = rec.stats(), rroof.parse_collectives(hlo)
    assert sum(want.counts.values()) == 1
    assert (got.counts, got.bytes_by_kind, got.link_bytes) == \
        (want.counts, want.bytes_by_kind, want.link_bytes)


# ------------------------------- counting -------------------------------

def test_prefill_flops_per_chip_equal_a_hand_count():
    """One layer of the smoke qwen1.5-0.5b (d 64, 4 heads and 2 KV heads
    of 16, d_ff 128, vocab 256), prefill_smoke (B 4, S 128, blocks of
    64) on the 2x2 mesh: rank 0 holds 2 sequences (data) and half of the
    heads, of d_ff and of the vocab (model)."""
    cfg = dataclasses.replace(dryrun.pad_vocab(smoke_config("qwen1.5-0.5b")),
                              n_layers=1)
    Bl, S, d, hd, Hl, KHl, fl, Vl = 2, 128, 64, 16, 2, 1, 64, 128
    T = Bl * S                                  # this rank's tokens
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    want = (mm(T, d, Hl * hd)                   # q
            + 2 * mm(T, d, KHl * hd)            # k, v
            + 2 * 2 * Bl * S * S * Hl * hd      # scores and values, every
                                                # (q, kv) block pair
            + mm(T, Hl * hd, d)                 # o
            + 3 * mm(T, d, fl)                  # gate, up, down
            + mm(Bl, d, Vl))                    # head, last position only
    assert want == 13_664_256
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES["prefill_smoke"],
                               mesh, q_block=64, kv_block=64)
    assert run.flops == want
    assert run.peak_bytes >= run.argument_bytes > 0
    assert run.coll.counts


def test_decode_flops_per_chip_equal_a_hand_count():
    """decode_smoke of the smoke qwen1.5-0.5b (2 layers; B 8, a cache of
    128) on the 2x2 mesh: rank 0 projects its 4 rows with half of the
    heads, of d_ff and of the vocab, and attends with its own 2 query
    heads and their KV head over its batch shard of the cache (the cache
    is split by batch only; each rank slices its KV heads).  Left
    unconstrained, DTensor ran the FFN on weights gathered over the
    model axis; attending with every head counted 622,592."""
    cfg = dryrun.pad_vocab(smoke_config("qwen1.5-0.5b"))
    Bl, Smax, d, hd, Hl, KHl, fl, Vl = 4, 128, 64, 16, 2, 1, 64, 128
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    layer = (mm(Bl, d, Hl * hd) + 2 * mm(Bl, d, KHl * hd)
             + 2 * 2 * Bl * Hl * Smax * hd      # scores and values
             + mm(Bl, Hl * hd, d) + 3 * mm(Bl, d, fl))
    want = 2 * layer + mm(Bl, d, Vl)
    assert want == 491_520
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES["decode_smoke"],
                               mesh)
    assert run.flops == want


def test_moe_train_flops_per_chip_equal_a_hand_count():
    """train_smoke of the smoke dbrx-132b (2 layers of d 64, 4 heads and
    2 KV heads of 16, 4 experts of d_ff 128, top-2, vocab 256; B 8, S
    128, no remat) on the 2x2 mesh, default dispatch: rank 0 holds 4
    sequences (T 1,024 tokens, 512 here) and half of the heads and of
    the vocab.  Its router runs on its own tokens; its expert products
    on its 2 of the 4 experts at every one of their C = 640 slots and
    half of d_ff.  Every product forward and its two backward ones.
    Routing all tokens on every rank counted 493,879,296."""
    cfg = dryrun.pad_vocab(smoke_config("dbrx-132b"))
    T, Bl, S, d, hd, Hl, KHl, Vl = 512, 4, 128, 64, 16, 2, 1, 128
    E, El, C, fl = 4, 2, 640, 64
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    layer = (mm(T, d, Hl * hd) + 2 * mm(T, d, KHl * hd)
             + 2 * 2 * Bl * S * S * Hl * hd     # scores and values
             + mm(T, Hl * hd, d)
             + mm(T, d, E)                      # router
             + El * (2 * mm(C, d, fl)           # gate, up
                     + mm(C, fl, d)))           # down
    want = 3 * (2 * layer + mm(T, d, Vl))
    assert want == 303_562_752
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES["train_smoke"],
                               mesh, q_block=64, kv_block=64)
    assert run.flops == want
    # the tokens travel to their experts and back by all-to-all, in each
    # layer forward and backward
    assert run.coll.counts["all-to-all"] == 2 * 2 * 2


def _split_heads_flops(name: str, shape: str) -> int:
    """A hand count for rank 0 of a 1x4 mesh (data 1, model 4) running
    a smoke config of 4 heads and 2 KV heads of 16 (d 64, 2 layers,
    vocab 256: 64 a rank; d_ff 128: 32 a rank): the KV heads do not
    divide ``model``, so the rank attends with its ONE query head (and
    the one KV head it reads), projects q and o on that head's 16
    columns, k and v on its 8 of the 32 KV columns.  train_smoke (B 8,
    S 128, no remat): every product forward and its two backward ones;
    dbrx-132b's expert products run on all 4 experts (data 1) at every
    one of their C = 640 slots.  decode_smoke (B 8, a cache of 128)."""
    d, hd, Hl, kvl, fl, Vl = 64, 16, 1, 8, 32, 64
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    if shape == "decode_smoke":
        Bl, Smax = 8, 128
        layer = (mm(Bl, d, Hl * hd + 2 * kvl)
                 + 2 * 2 * Bl * Hl * Smax * hd  # scores and values
                 + mm(Bl, Hl * hd, d) + 3 * mm(Bl, d, fl))
        return 2 * layer + mm(Bl, d, Vl)
    Bl, S = 8, 128
    T = Bl * S
    layer = (mm(T, d, Hl * hd + 2 * kvl)        # q, k, v
             + 2 * 2 * Bl * S * S * Hl * hd     # scores and values
             + mm(T, Hl * hd, d))               # o
    if name == "dbrx-132b":
        E, C = 4, 640
        layer += mm(T, d, E) + E * (2 * mm(C, d, fl) + mm(C, fl, d))
    else:
        layer += 3 * mm(T, d, fl)               # gate, up, down
    return 3 * (2 * layer + mm(T, d, Vl))


@pytest.mark.parametrize("name,shape,want,before", [
    ("dbrx-132b", "train_smoke", 305_135_616, 468_713_472),
    ("internlm2-1.8b", "train_smoke", 188_743_680, 352_321_536),
    ("internlm2-1.8b", "decode_smoke", 491_520, 884_736),
])
def test_split_query_heads_flops_per_chip_equal_a_hand_count(
        name, shape, want, before):
    """Where the KV heads do not divide ``model`` each rank attends with
    its own query heads (``before``: the count when every rank attended
    with all 4 heads and ran o's weight gradient on the whole output).
    In training, K's and V's gradients are reduce-scattered back to the
    rank's columns, once a layer each."""
    from torch.distributed.device_mesh import init_device_mesh
    assert _split_heads_flops(name, shape) == want < before
    cfg = dryrun.pad_vocab(smoke_config(name))
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    with placeholder_world(4, "cpu"):
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES[shape], mesh,
                               q_block=64, kv_block=64)
    assert run.flops == want
    if shape == "train_smoke":
        assert run.coll.counts["reduce-scatter"] == 2 * 2


def test_ssm_prefill_flops_per_chip_equal_a_hand_count():
    """prefill_smoke of the smoke mamba2-130m (2 layers of d 64, d_in
    128 in 8 heads of 16, state 16, one group, a packed in_proj of 296
    columns, vocab 256; B 4, S 128, one chunk of 128) on the 2x2 mesh:
    rank 0 projects its 2 sequences onto its half of the packed columns,
    runs the SSD core on its 4 heads (after gathering the packed
    projection) and out_proj on their 64 channels.  The core on every
    head counted 51,675,136."""
    cfg = dryrun.pad_vocab(smoke_config("mamba2-130m"))
    Bl, S, d, P, Hl, N, Q = 2, 128, 64, 16, 4, 16, 128
    T = Bl * S
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    nb = Bl * (S // Q) * Hl                     # (sequence, chunk, head)
    layer = (mm(T, d, 296 // 2)                 # in_proj
             + nb * (mm(Q, N, Q)                # C B^T within the chunk
                     + mm(Q, Q, P)              # ... times dt x
                     + mm(N, Q, P)              # the chunk's state
                     + mm(Q, N, P))             # C times the state in
             + mm(T, Hl * P, d))                # out_proj
    want = 2 * layer + mm(Bl, d, 128)           # head, last position
    assert want == 32_800_768
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES["prefill_smoke"],
                               mesh, q_block=64, kv_block=64)
    assert run.flops == want


def test_ssm_decode_flops_per_chip_equal_a_hand_count():
    """decode_smoke of the smoke mamba2-130m (B 8) on the 2x2 mesh: rank
    0 steps its 4 rows through its 4 heads: the packed projection on its
    half of the columns, the depthwise conv of its heads' 64 x channels
    and the 32 shared B and C ones (a (4 x 4) by (4 x 1) product a
    channel), C times the new state, out_proj on its 64 channels.  The
    core on every head counted 325,632."""
    cfg = dryrun.pad_vocab(smoke_config("mamba2-130m"))
    Bl, d, P, Hl, N, K = 4, 64, 16, 4, 16, 4
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    layer = (mm(Bl, d, 296 // 2)                # in_proj
             + (Hl * P + 2 * N) * mm(Bl, K, 1)  # the conv window
             + Bl * Hl * mm(1, N, P)            # y = C . state
             + mm(Bl, Hl * P, d))               # out_proj
    want = 2 * layer + mm(Bl, d, 128)
    assert want == 305_152
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        run = dryrun._run_cell(cfg, dryrun.SMOKE_SHAPES["decode_smoke"],
                               mesh)
    assert run.flops == want


def test_uneven_shards_raise():
    """A dim the mesh does not divide fails the cell, as the reference's
    ``jit`` refuses such an argument, rather than give wrong global
    shapes: long_500k's one sequence on the 16-wide data axis, and a
    ``local_apply`` argument split unevenly."""
    with pytest.raises(ValueError, match="does not divide"):
        dryrun.lower_cell("mamba2-130m", "long_500k", False, device="cpu")
    assert not dist.is_initialized()
    with placeholder_world(4, "cpu"):
        mesh = make_smoke_mesh("cpu")
        with FakeTensorMode(), active_mesh(mesh):
            x = distribute_tensor(torch.empty(3, 4), mesh,
                                  [Shard(0), Replicate()])
            with pytest.raises(ValueError, match="does not divide"):
                local_apply(lambda t: t * 2, (x,), [("batch", None)],
                            ("batch", None))
    assert not dist.is_initialized()


def test_run_smoke_all_cells(tmp_path):
    records = []
    failures = dryrun.run_smoke(tmp_path, device="cpu", records=records)
    assert failures == []
    assert [(r["arch"], r["shape"]) for r in records] == dryrun.SMOKE_CELLS
    assert len(list(tmp_path.glob("smoke__*.json"))) == 5
    for r in records:
        assert r["mesh"] == "2x2" and r["n_chips"] == 4
        assert r["cost"]["flops"] > 0
        assert r["cost"]["corrected_by_probes"] is False
        assert r["memory"]["argument_bytes"] > 0
        assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"]
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
        assert sum(r["collectives"]["counts"].values()) > 0
    assert not dist.is_initialized()


PRODUCTION_PEAK_BYTES = 16_589_204_492


def train_flops_hand_count():
    """The products one chip of 256 runs in a qwen1.5-0.5b train_4k step
    on 16x16 (d 1024, 16 heads of 64, d_ff 2816, vocab 151,936, 24
    layers; 16 sequences of 4,096 tokens a chip; heads, d_ff and vocab
    split 16 ways; one 4,096-row attention block): the head forward and
    its two backward products; every layer forward, recomputed (its
    checkpoint stops before the down projection, which the backward does
    not need) and its two backward products.  A product run on a whole
    weight, or on every head, would add to it."""
    T, S, d, hl, fl, vl, L = 16 * 4096, 4096, 1024, 64, 176, 9496, 24
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    fwd = (mm(T, d, 3 * hl) + mm(T, hl, d)      # q, k, v; o
           + mm(T, d, 2 * fl) + mm(T, fl, d)    # gate, up; down
           + 2 * 2 * T * S * hl)                # scores and values
    want = 3 * mm(T, d, vl) + L * (4 * fwd - mm(T, fl, d))
    assert want == 19_955_491_799_040
    return want


def moe_train_flops_hand_count():
    """The products one chip of 256 runs in a dbrx-132b train_4k step on
    16x16 (d 6144, 48 heads and 8 KV heads of 128, 16 experts of d_ff
    10,752, top-4, vocab 100,352, 40 layers; 16 sequences of 4,096
    tokens a chip; one 4,096-row attention block; every layer
    checkpointed): the head forward and its two backward products; every
    layer forward, recomputed and its two backward products.  A layer:
    q and o on the rank's 3 of the 48 heads (the 8 KV heads do not
    divide the 16-wide model axis, so K and V are gathered and each rank
    attends with its own query heads), k and v on its 64 of the 1,024 KV
    columns, the router on its tokens, the expert products on its 1 of
    16 experts at every one of the C = 327,680 slots and 672 of d_ff
    (the down projection is recomputed: the combine's backward needs
    its output).  Attending with every head counted
    2,672,534,810,001,408."""
    T, S, d, hl, kvl, L = 16 * 4096, 4096, 6144, 384, 64, 40
    E, C, fl, vl = 16, 256 * 4096 * 4 * 5 // (4 * 16), 672, 6272
    mm = lambda m, k, n: 2 * m * k * n          # noqa: E731
    fwd = (mm(T, d, hl + 2 * kvl) + mm(T, hl, d)  # q, k, v; o
           + 2 * 2 * T * S * hl                 # scores and values
           + mm(T, d, E)                        # router
           + 2 * mm(C, d, fl) + mm(C, fl, d))   # the rank's expert
    want = 3 * mm(T, d, vl) + L * 4 * fwd
    assert want == 1_497_431_757_815_808
    return want


def test_moe_production_cell_count():
    rec = dryrun.lower_cell("dbrx-132b", "train_4k", False, device="cpu",
                            q_block=4096, kv_block=4096)
    assert rec["cost"]["flops"] == moe_train_flops_hand_count()
    # K's and V's gradients are reduce-scattered back to the rank's KV
    # columns, in each of the 40 layers
    assert rec["collectives"]["counts"]["reduce-scatter"] >= 2 * 40
    assert not dist.is_initialized()


def test_production_cell_cli(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--device", "cpu",
         "--q-block", "4096", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**__import__("os").environ,
             "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["qwen1.5-0.5b__train_4k__16x16.json"]
    rec = json.loads(files[0].read_text())
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["params"] == 619_495_424
    assert rec["cost"]["flops"] == train_flops_hand_count()
    # the peak is in the loss: five float32 (16, 4096, 9496) logit shards,
    # the 24 layers' saved inputs and the arguments' shards; torch 2.11
    # and 2.13 lay the step out alike and count the same bytes
    assert rec["memory"]["peak_bytes"] == PRODUCTION_PEAK_BYTES
    assert rec["cost"]["flops"] > rec["roofline"]["model_flops_per_chip"] > 0
    assert set(rec["collectives"]["counts"]) >= {"all-gather", "all-reduce"}
    assert rec["hardware"] == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                               "link_bw": 450e9,
                               "model": "NVIDIA H100 SXM datasheet"}
    r = rec["roofline"]
    assert r["compute_s"] == rec["cost"]["flops"] / 989e12
    assert r["collective_s"] == rec["collectives"]["link_bytes"] / 450e9
    assert r["memory_s"] == r["memory_bytes_analytical"] / 3.35e12
    assert r["dominant"] in ("compute", "memory", "collective")


# ----------------------------- sharded numerics -----------------------------

B, S, BLOCK, TOL, SHARD_TOL = 4, 16, 8, 1e-4, 1e-5
CASES = (("qwen1.5-0.5b", {}), ("dbrx-132b", {}),
         ("dbrx-132b", {"moe_ep": True}), ("mamba2-130m", {}),
         ("zamba2-7b", {}))
DECODE_ARCHS = ("qwen1.5-0.5b", "mamba2-130m", "zamba2-7b")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _np(t):
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _case(name, opts) -> str:
    return " ".join([name, *(f"{k}={v}" for k, v in opts.items())])


def _mesh_worker(rank, port, ref_params, batches, out_q):
    """One of 4 ranks of a 2x2 gloo mesh: each case's forward, loss and
    gradients sharded, against the same computed unsharded on this rank;
    rank 0 reports the unsharded values, the largest differences and
    whether the MoE keep masks of every routing were the same."""
    from repro_torch.dist.api import active_mesh, options
    from repro_torch.dist.sharding import (distribute, make_batch_specs,
                                           make_param_specs, rules_for)
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_reference
    torch.set_num_threads(1)
    keeps = []
    assign = moe._assign

    def recording(*a):
        out = assign(*a)
        keeps.append(out[2].clone())
        return out
    moe._assign = recording
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = make_smoke_mesh("cpu")
        report = {}
        for (name, opts), rp, nb in zip(CASES, ref_params, batches):
            cfg = _f32(smoke_config(name))
            params = params_from_reference(rp, cfg, device="cpu")
            _, axes = lm.init_params(cfg, device="meta")
            batch = {k: torch.from_numpy(v.copy()) for k, v in nb.items()}
            kw = dict(q_block=BLOCK, kv_block=BLOCK)
            keeps.clear()
            with options(**opts):
                logits = lm.forward(params, cfg, batch, **kw)
                loss, grads = loss_and_grads(params, cfg, batch, **kw)
            want_keeps = list(keeps)
            keeps.clear()
            with active_mesh(mesh), options(**opts):
                sp = distribute(params, make_param_specs(
                    axes, params, mesh, rules_for(cfg, mesh)))
                sb = distribute(batch, make_batch_specs(batch, mesh))
                slogits = lm.forward(sp, cfg, sb, **kw)
                sloss, sgrads = loss_and_grads(sp, cfg, sb, **kw)
            assert all(isinstance(g, DTensor) for g in _leaves(sgrads))
            diff = {"logits": float(np.abs(_np(slogits) - _np(logits)).max()),
                    "loss": abs(float(_np(sloss)) - float(loss)),
                    "grads": max(float(np.abs(_np(a) - _np(b)).max())
                                 for a, b in zip(_leaves(sgrads),
                                                 _leaves(grads)))}
            report[_case(name, opts)] = {
                "diff": diff, "loss": float(loss),
                "grads": [_np(g) for g in _leaves(grads)],
                "keeps": (len(keeps), sum(int((~k).sum()) for k in keeps),
                          len(keeps) == len(want_keeps) and all(
                              torch.equal(a, b)
                              for a, b in zip(keeps, want_keeps)))}
        report["decode"] = _sharded_decode_diff(mesh)
        if rank == 0:
            out_q.put(report)
    finally:
        dist.destroy_process_group()


def _sharded_decode_diff(mesh) -> dict:
    """3 decode steps of three smoke archs (dense, SSM, hybrid), sharded
    against unsharded: the largest difference of the logits and of the
    caches, with the cache's batch sharded and with the KV cache's
    sequence sharded too (``kv_seq_model``), whose writes must land in
    the ranks' slices."""
    from repro_torch.dist.api import active_mesh
    from repro_torch.dist.sharding import (distribute, make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs, rules_for)
    out = {}
    for name in DECODE_ARCHS:
        cfg = _f32(smoke_config(name))
        params, axes = lm.init_params(cfg, device="cpu")
        toks = [torch.full((B, 1), 7 * i + 3, dtype=torch.int32)
                for i in range(3)]
        cache = lm.init_cache(cfg, B, S, device="cpu")
        want = [lm.decode_step(params, cfg, cache, {"tokens": t}, i)[0]
                for i, t in enumerate(toks)]
        for kv in (False, True):
            rules = dataclasses.replace(rules_for(cfg, mesh), fsdp=False,
                                        zero1=False, kv_seq_model=kv)
            with active_mesh(mesh):
                sp = distribute(params, make_param_specs(axes, params, mesh,
                                                         rules))
                c0 = lm.init_cache(cfg, B, S, device="cpu")
                sc = distribute(c0, make_cache_specs(c0, mesh, rules, B))
                got = []
                for i, t in enumerate(toks):
                    b = {"tokens": t}
                    lg, sc = lm.decode_step(
                        sp, cfg, sc, distribute(b, make_batch_specs(b, mesh)),
                        i)
                    got.append(lg)
            out[f"{name} kv_seq_model={kv}"] = max(
                [float(np.abs(_np(a) - _np(b)).max())
                 for a, b in zip(got, want)]
                + [float(np.abs(_np(sc[k]) - _np(cache[k])).max())
                   for k in cache])
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_numerics_on_a_2x2_gloo_mesh():
    import jax

    from repro.configs import smoke_config as rsmoke
    from repro.launch import train as rtrain
    from repro.models import lm as rlm
    ref_params, batches, cfgs = [], [], []
    for name, _ in CASES:
        cfg = _f32(rsmoke(name))
        rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
        ref_params.append(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       rp))
        batches.append({k: np.asarray(v) for k, v in
                        rtrain.synthetic_batch(cfg, B, S, 0).items()})
        cfgs.append(cfg)
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_worker,
                         args=(r, port, ref_params, batches, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        # the reference's values, while the 4 ranks run
        want = {}
        for (name, _), cfg, rp, nb in zip(CASES, cfgs, ref_params, batches):
            if name in want:
                continue
            lval, g = jax.jit(jax.value_and_grad(
                lambda p, b: rlm.loss_fn(p, cfg, b, q_block=BLOCK,
                                         kv_block=BLOCK)))(rp, nb)
            want[name] = (float(lval),
                          [np.asarray(x, np.float32) for x in _leaves(g)])
        report = q.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * 4
    assert len(report["decode"]) == 2 * len(DECODE_ARCHS)
    assert max(report["decode"].values()) <= SHARD_TOL, report["decode"]
    for name, opts in CASES:
        r = report[_case(name, opts)]
        assert max(r["diff"].values()) <= SHARD_TOL, (name, r["diff"])
        n_keeps, n_dropped, same = r["keeps"]
        # the forward and the loss route each of the 2 layers once, and
        # the capacity drops some assignments: the masks are not all ones
        if name == "dbrx-132b":
            assert n_keeps == 4 and n_dropped > 0, r["keeps"]
        assert same, (name, opts, r["keeps"])
        rl, rg = want[name]
        assert abs(r["loss"] - rl) <= TOL * (1 + abs(rl)), name
        assert len(r["grads"]) == len(rg)
        for got, ref in zip(r["grads"], rg):
            scale = np.abs(ref).max() or 1.0
            assert np.abs(got - ref).max() <= TOL * scale, name


SPLIT_ARCH, SPLIT_DECODE_STEPS = "internlm2-1.8b", 16


def _split_heads_worker(rank, port, out_q):
    """One of 4 ranks of a 1x4 gloo mesh (``model`` 4): the smoke
    internlm2-1.8b's 4 query heads split one a rank while its 2 KV heads
    do not divide the axis (each rank holds half of one in K and V).
    Forward, loss and gradients, and 16 decode steps with the cache split
    by batch and then by sequence too, sharded against unsharded; rank 0
    reports the largest differences and the ranks' head layout."""
    from repro_torch.dist.api import active_mesh
    from repro_torch.dist.sharding import (distribute, make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs, rules_for)
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import attention
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        cfg = _f32(smoke_config(SPLIT_ARCH))
        params, axes = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        batch = synthetic_batch(cfg, B, S, 0, device="cpu")
        kw = dict(q_block=BLOCK, kv_block=BLOCK)
        logits = lm.forward(params, cfg, batch, **kw)
        loss, grads = loss_and_grads(params, cfg, batch, **kw)
        rules = rules_for(cfg, mesh)
        with active_mesh(mesh):
            layout = (attention._head_axis(cfg, mesh),
                      attention._kv_split(cfg, mesh))
            sp = distribute(params, make_param_specs(axes, params, mesh,
                                                     rules))
            sb = distribute(batch, make_batch_specs(batch, mesh))
            slogits = lm.forward(sp, cfg, sb, **kw)
            sloss, sgrads = loss_and_grads(sp, cfg, sb, **kw)
        diff = {"logits": float(np.abs(_np(slogits) - _np(logits)).max()),
                "loss": abs(float(_np(sloss)) - float(loss)),
                "grads": max(float(np.abs(_np(a) - _np(b)).max())
                             for a, b in zip(_leaves(sgrads),
                                             _leaves(grads)))}
        toks = [torch.full((B, 1), 5 * i + 1, dtype=torch.int32)
                for i in range(SPLIT_DECODE_STEPS)]
        cache = lm.init_cache(cfg, B, SPLIT_DECODE_STEPS, device="cpu")
        want = [lm.decode_step(params, cfg, cache, {"tokens": t}, i)[0]
                for i, t in enumerate(toks)]
        for kv in (False, True):
            r = dataclasses.replace(rules, fsdp=False, zero1=False,
                                    kv_seq_model=kv)
            with active_mesh(mesh):
                sp = distribute(params, make_param_specs(axes, params, mesh,
                                                         r))
                c0 = lm.init_cache(cfg, B, SPLIT_DECODE_STEPS, device="cpu")
                sc = distribute(c0, make_cache_specs(c0, mesh, r, B))
                got = []
                for i, t in enumerate(toks):
                    b = {"tokens": t}
                    lg, sc = lm.decode_step(
                        sp, cfg, sc, distribute(b, make_batch_specs(b, mesh)),
                        i)
                    got.append(lg)
            diff[f"decode kv_seq_model={kv}"] = max(
                [float(np.abs(_np(a) - _np(b)).max())
                 for a, b in zip(got, want)]
                + [float(np.abs(_np(sc[k]) - _np(cache[k])).max())
                   for k in cache])
        report = [None] * 4
        dist.all_gather_object(report, (layout, diff))
        if rank == 0:
            out_q.put(report)
    finally:
        dist.destroy_process_group()


def test_split_query_heads_on_a_1x4_gloo_mesh():
    """Where the KV heads do not divide ``model``, each rank attends with
    its own query heads and the KV heads they read: within 1e-5 of the
    unsharded port in training and over 16 decode steps."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_split_heads_worker, args=(r, port, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        report = q.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * 4
    # rank r holds query head r (4 heads of 16 over 4) and reads KV
    # head r // 2
    assert [layout for layout, _ in report] == \
        [("model", (r, 1)) for r in range(4)]
    for _, diff in report:
        assert len(diff) == 5
        assert max(diff.values()) <= SHARD_TOL, diff


def collective_table() -> str:
    """Both packages' smoke sweeps on the CPU, per cell and collective
    kind: the reference's count of collectives in the compiled HLO
    (``parse_collectives`` of XLA's partitioned module on 8 placeholder
    host devices) beside the port's count of the collectives DTensor
    issued (``CollectiveRecorder``).  Run as ``PYTHONPATH=src
    JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py``."""
    import os
    import tempfile
    os.environ.setdefault("REPRO_DRYRUN_DEVICES", "8")
    from repro.configs import smoke_config as rsmoke
    from repro.launch import dryrun as rdry
    kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
             "collective-permute")
    rows = ["| cell | " + " | ".join(f"{k}: ref / port" for k in kinds)
            + " |", "|---" * (len(kinds) + 1) + "|"]
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        assert dryrun.run_smoke(pathlib.Path(tmp), device="cpu",
                                records=records) == []
    # the reference's make_smoke_mesh, with Auto axes: jax.make_mesh now
    # makes Explicit ones, under which its constrain cannot compile
    import jax
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for (arch, sname), rec in zip(dryrun.SMOKE_CELLS, records):
        compiled, _, _ = rdry._compile_cell(
            rdry.pad_vocab(rsmoke(arch)), rdry.SMOKE_SHAPES[sname], mesh,
            q_block=64, kv_block=64)
        ref = rroof.parse_collectives(compiled.as_text()).counts
        port = rec["collectives"]["counts"]
        rows.append(f"| {arch} {sname} | " + " | ".join(
            f"{ref.get(k, 0)} / {port.get(k, 0)}" for k in kinds) + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(collective_table())
