"""The port's sharding layer and roofline model against the JAX package,
exactly (spec tuples ``==``, floats ``==``), and the sharded model's
numerics against the unsharded port.

* The six sharding and roofline tests of ``tests/test_dist.py``, each
  also holding the port's answer equal to the reference's.
* ``_spec_for`` over every parameter leaf of every registered arch at
  full config (the reference's shapes from ``jax.eval_shape``, the
  port's from meta ``init_params``, the same key paths), on 16x16,
  2x16x16 and 2x2 meshes (the port's on placeholder worlds), under
  ``rules_for``'s default and each single flip of its fields.
* ``make_batch_specs`` and ``make_cache_specs`` on every arch's inputs
  and caches; ``analytical_memory_bytes`` and ``model_flops`` for every
  arch x shape at 256 and 512 chips; the dry run's ``pad_vocab``,
  ``depth_units``, ``_serve_fsdp`` and ``cells()``.
* The reference's ``analytical_memory_bytes`` divides by zero below 16
  chips (pinned); the port's is defined there.
* A 1x1 mesh over a 1-rank gloo group: 3 train steps bit-identical to
  the same steps without a mesh.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as rconfigs
from repro.dist import sharding as rsharding
from repro.launch import roofline as rroof
from repro.launch import specs as rspecs
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     make_smoke_mesh, placeholder_world)
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

# the reference's dry run forces 512 XLA host devices through XLA_FLAGS
# when it is imported; keep that flag out of this process
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as rdry  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

NAMES = sorted(rconfigs.ARCHS)
MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2)}
FLIPS = ("fsdp", "zero1", "heads_ok", "tp2d", "kv_seq_model", "dp_only")


def fake_mesh(**axes):
    """The reference's test mesh: axis names and a devices array."""
    m = types.SimpleNamespace()
    m.axis_names = tuple(axes.keys())
    m.devices = np.empty(tuple(axes.values()))
    return m


def port_mesh(name):
    """A context giving the port's DeviceMesh of ``name`` on a
    placeholder world of as many ranks."""
    axes = MESHES[name]
    n = int(np.prod(list(axes.values())))

    class _Ctx:
        def __enter__(self):
            self.world = placeholder_world(n, "cpu")
            self.world.__enter__()
            if name == "2x2":
                return make_smoke_mesh("cpu")
            return make_production_mesh(multi_pod=name == "2x16x16",
                                        device_type="cpu")

        def __exit__(self, *exc):
            return self.world.__exit__(*exc)
    return _Ctx()


@pytest.fixture
def m16():
    with port_mesh("16x16") as m:
        yield m


R16 = fake_mesh(data=16, model=16)


def same(port_spec, ref_spec) -> bool:
    return tuple(port_spec) == tuple(ref_spec)


# ------------------ the six tests of tests/test_dist.py ------------------

def test_tp_axis_assignment(m16):
    r, rr = tsharding.ShardingRules(), rsharding.ShardingRules()
    for axes, shape, want in ((("embed", "ffn"), (1024, 2816),
                               ("data", "model")),
                              (("vocab", "embed"), (151936, 1024),
                               ("model", None))):
        got = tsharding._spec_for(axes, shape, m16, r)
        assert tuple(got) == want
        assert same(got, rsharding._spec_for(axes, shape, R16, rr))


def test_heads_fallback(m16):
    for ok in (True, False):
        got = tsharding._spec_for(("embed", "heads_flat"), (5120, 5120), m16,
                                  tsharding.ShardingRules(heads_ok=ok))
        want = rsharding._spec_for(("embed", "heads_flat"), (5120, 5120),
                                   R16, rsharding.ShardingRules(heads_ok=ok))
        assert same(got, want)
        assert ("model" in got) is ok


def test_structural_dims_never_fsdp(m16):
    args = (("layers", "embed", "ffn"), (24, 1024, 2816))
    spec = tsharding._spec_for(*args, m16, tsharding.ShardingRules())
    assert spec[0] is None and spec[2] == "model"
    assert same(spec, rsharding._spec_for(*args, R16,
                                          rsharding.ShardingRules()))


def test_indivisible_replicates(m16):
    spec = tsharding._spec_for(("embed", "ffn"), (1000, 30), m16,
                               tsharding.ShardingRules())
    assert tuple(spec) == (None, None)
    assert same(spec, rsharding._spec_for(("embed", "ffn"), (1000, 30), R16,
                                          rsharding.ShardingRules()))


def test_hlo_collective_parser():
    hlo = """
  %all-gather = f32[256,4096]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = (bf16[128]{0}, bf16[64]{0}) all-reduce(%a, %b), replica_groups={{0,1,2,3}}
  %cp = u8[1024]{0} collective-permute(%y), source_target_pairs={{0,1}}
  %ignored = f32[8]{0} add(%p, %q)
"""
    st = troof.parse_collectives(hlo)
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "collective-permute": 1}
    assert st.bytes_by_kind["all-gather"] == 256 * 4096 * 4
    assert st.bytes_by_kind["all-reduce"] == (128 + 64) * 2
    assert st.bytes_by_kind["collective-permute"] == 1024
    assert st.link_bytes > 0
    ref = rroof.parse_collectives(hlo)
    assert (st.counts, st.bytes_by_kind, st.link_bytes) == \
        (ref.counts, ref.bytes_by_kind, ref.link_bytes)


def test_analytical_memory_positive():
    for name in NAMES:
        for s in rconfigs.SHAPES:
            b = troof.analytical_memory_bytes(tconfigs.ARCHS[name],
                                              tconfigs.SHAPES[s], 256)
            assert b > 0
            assert b == rroof.analytical_memory_bytes(
                rconfigs.ARCHS[name], rconfigs.SHAPES[s], 256)


# ------------------------- every leaf, every mesh -------------------------

def _ref_params(cfg):
    box = {}

    def f(key):
        p, ax = rlm.init_params(cfg, key)
        box["ax"] = ax
        return p
    return jax.eval_shape(f, jax.random.PRNGKey(0)), box["ax"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _rule_sets(rules):
    yield rules
    for f in FLIPS:
        yield dataclasses.replace(rules, **{f: not getattr(rules, f)})


@pytest.mark.parametrize("name", NAMES)
def test_spec_for_every_leaf(name):
    rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
    rshapes, raxes = _ref_params(rcfg)
    tshapes, taxes = tlm.init_params(tcfg, device="meta")
    rleaves = list(_leaves(rshapes))
    tleaves = list(_leaves(tshapes))
    assert [p for p, _ in rleaves] == [p for p, _ in tleaves]
    assert [tuple(a.shape) for _, a in rleaves] == \
        [tuple(a.shape) for _, a in tleaves]
    axes = [a for _, a in _leaves(taxes)]
    assert axes == [a for _, a in _leaves(raxes)]
    n = 0
    for mname, sizes in MESHES.items():
        rmesh = fake_mesh(**sizes)
        with port_mesh(mname) as mesh:
            rrules = rsharding.rules_for(rcfg, rmesh)
            trules = tsharding.rules_for(tcfg, mesh)
            assert dataclasses.asdict(trules) == dataclasses.asdict(rrules)
            for tr in _rule_sets(trules):
                rr = rsharding.ShardingRules(**dataclasses.asdict(tr))
                for ax, (_, leaf) in zip(axes, tleaves):
                    got = tsharding._spec_for(ax, tuple(leaf.shape), mesh,
                                              tr)
                    want = rsharding._spec_for(ax, tuple(leaf.shape), rmesh,
                                               rr)
                    assert same(got, want), (mname, tr, ax, leaf.shape)
                    n += 1
                # the port's trees: params and moments laid out per leaf
                ps = tsharding.make_param_specs(taxes, tshapes, mesh, tr)
                ms = tsharding.moment_specs(taxes, tshapes, mesh, tr)
                for (_, s), (_, leaf), ax in zip(_leaves(ps), tleaves, axes):
                    assert same(s.spec, rsharding._spec_for(
                        ax, tuple(leaf.shape), rmesh, rr))
                    assert len(s.placements) == len(sizes)
                for (_, s), (_, leaf) in zip(_leaves(ms), tleaves):
                    if not (tr.zero1 or tr.fsdp):
                        assert tuple(s.spec) == (None,) * leaf.ndim
    assert n == len(axes) * len(MESHES) * (1 + len(FLIPS))


@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_specs(name, monkeypatch):
    # the reference wraps each spec in a NamedSharding, which needs a
    # mesh of real devices; its specs are what is compared
    monkeypatch.setattr(rsharding, "NamedSharding", lambda mesh, spec: spec)
    rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
    for mname, sizes in MESHES.items():
        rmesh = fake_mesh(**sizes)
        with port_mesh(mname) as mesh:
            rules = tsharding.rules_for(tcfg, mesh)
            rrules = rsharding.rules_for(rcfg, rmesh)
            for sname, rshape in rconfigs.SHAPES.items():
                tshape = tconfigs.SHAPES[sname]
                for rf, tf in ((rspecs.input_specs, tspecs.input_specs),
                               (rspecs.decode_input_specs,
                                tspecs.decode_input_specs)):
                    rin, tin = rf(rcfg, rshape), tf(tcfg, tshape)
                    assert {k: (tuple(v.shape), str(v.dtype))
                            for k, v in rin.items()} == \
                        {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                         for k, v in tin.items()}
                    for all_axes in (False, True):
                        want = rsharding.make_batch_specs(
                            rin, rmesh, all_axes=all_axes)
                        got = tsharding.make_batch_specs(
                            tin, mesh, all_axes=all_axes)
                        assert {k: tuple(v.spec) for k, v in got.items()} \
                            == {k: tuple(v) for k, v in want.items()}
                B, S = rshape.global_batch, rshape.seq_len
                rc = rspecs.abstract_cache(rcfg, B, S)
                tc = tspecs.abstract_cache(tcfg, B, S)
                assert {k: tuple(v.shape) for k, v in rc.items()} == \
                    {k: tuple(v.shape) for k, v in tc.items()}
                for kv in (False, True):
                    rr = dataclasses.replace(rrules, kv_seq_model=kv)
                    tr = dataclasses.replace(rules, kv_seq_model=kv)
                    want = rsharding.make_cache_specs(rc, rmesh, rr, B)
                    got = tsharding.make_cache_specs(tc, mesh, tr, B)
                    assert {k: tuple(v.spec) for k, v in got.items()} == \
                        {k: tuple(v) for k, v in want.items()}


def test_memory_and_model_flops_every_cell():
    for name in NAMES:
        for pad in (False, True):
            rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
            if pad:
                rcfg, tcfg = rdry.pad_vocab(rcfg), tdry.pad_vocab(tcfg)
                assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
            for sname in rconfigs.SHAPES:
                rs, ts = rconfigs.SHAPES[sname], tconfigs.SHAPES[sname]
                for n in (256, 512):
                    for kv in (1, 16):
                        assert troof.analytical_memory_bytes(
                            tcfg, ts, n, kv_extra_shard=kv) == \
                            rroof.analytical_memory_bytes(
                                rcfg, rs, n, kv_extra_shard=kv)
                    assert troof.model_flops(tcfg, ts, n) == \
                        rroof.model_flops(rcfg, rs, n)


def test_dryrun_helpers_equal():
    assert tdry.SERVE_FSDP_BYTES == rdry.SERVE_FSDP_BYTES
    assert {k: dataclasses.asdict(v) for k, v in tdry.SMOKE_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rdry.SMOKE_SHAPES.items()}
    assert tdry.SMOKE_CELLS == rdry.SMOKE_CELLS
    for mp in (False, True):
        assert list(tdry.cells(mp)) == list(rdry.cells(mp))
    for name in NAMES:
        rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
        for f in ("pad_vocab",):
            assert dataclasses.asdict(getattr(tdry, f)(tcfg)) == \
                dataclasses.asdict(getattr(rdry, f)(rcfg))
        assert tdry.depth_units(tcfg) == rdry.depth_units(rcfg)
        for k in (1, 2):
            assert dataclasses.asdict(tdry.layers_scaled(tcfg, k)) == \
                dataclasses.asdict(rdry.layers_scaled(rcfg, k))
        for mname, sizes in MESHES.items():
            with port_mesh(mname) as mesh:
                assert tdry._serve_fsdp(tcfg, mesh) == \
                    rdry._serve_fsdp(rcfg, fake_mesh(**sizes))


def test_reference_analytical_memory_fault():
    """The reference hard-codes a model axis of 16 and divides by
    ``n_chips // 16``: below 16 chips it raises ZeroDivisionError.  The
    port takes the model axis and is defined on any mesh, equal to the
    reference wherever the reference returns."""
    rcfg, rs = rconfigs.get_arch("qwen1.5-0.5b"), rconfigs.SHAPES["train_4k"]
    tcfg, ts = tconfigs.get_arch("qwen1.5-0.5b"), tconfigs.SHAPES["train_4k"]
    for n in (1, 8):
        with pytest.raises(ZeroDivisionError):
            rroof.analytical_memory_bytes(rcfg, rs, n)
        assert troof.analytical_memory_bytes(tcfg, ts, n) > 0
    with pytest.raises(ZeroDivisionError):
        rroof.analytical_memory_bytes(rcfg, rconfigs.SHAPES["decode_32k"], 8)
    assert troof.analytical_memory_bytes(tcfg, tconfigs.SHAPES["decode_32k"],
                                         8) > 0
    for n in (16, 256, 512):
        assert troof.analytical_memory_bytes(tcfg, ts, n) == \
            rroof.analytical_memory_bytes(rcfg, rs, n)
    # the 2x2 smoke mesh: its own model axis
    assert troof.analytical_memory_bytes(tcfg, ts, 4, model_axis=2) > 0


# ------------------------- a 1x1 mesh -------------------------

B, S, BLOCK = 4, 16, 8


def test_host_mesh_train_steps_bit_identical():
    """On a 1x1 mesh every placement is whole: 3 train steps over DTensor
    params, moments and batches give the losses and params of the same
    steps without a mesh, to the bit."""
    from repro_torch.dist.api import active_mesh
    from repro_torch.dist.sharding import (P, Sharding, distribute,
                                           make_batch_specs, make_param_specs,
                                           moment_specs, rules_for)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = tconfigs.smoke_config("qwen1.5-0.5b")
    params, axes = tlm.init_params(cfg, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           q_block=BLOCK, kv_block=BLOCK)
    data = [synthetic_batch(cfg, 2, S, i, device="cpu") for i in range(3)]
    state = {"params": params, "opt": adamw_init(params)}
    plain = []
    for b in data:
        state, loss = step(state, b)
        plain.append(loss)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh("cpu")
        rules = rules_for(cfg, mesh)
        ms = moment_specs(axes, params, mesh, rules)
        sstate = distribute({"params": params, "opt": adamw_init(params)},
                            {"params": make_param_specs(axes, params, mesh,
                                                        rules),
                             "opt": {"step": Sharding(mesh, P()), "mu": ms,
                                     "nu": ms}})
        with active_mesh(mesh):
            for b, want in zip(data, plain):
                sstate, loss = step(sstate, distribute(
                    b, make_batch_specs(b, mesh)))
                assert torch.equal(loss.full_tensor(), want)
        for (_, got), (_, ref) in zip(_leaves(sstate["params"]),
                                      _leaves(state["params"])):
            assert torch.equal(got.full_tensor(), ref)
    finally:
        dist.destroy_process_group()


def test_recompute_on_another_thread_keeps_mesh_and_options():
    """A checkpointed block is recomputed in the backward pass, which on
    the card runs on autograd's own thread: it must see the forward's
    options (and mesh), which are thread-local.  Here the backward runs
    on another thread: the gradient equals the one taken on this thread
    (before the fix, the recomputation ran without ``moe_groups`` and
    checkpoint refused the different number of saved tensors)."""
    import threading
    from repro_torch.dist.api import options
    cfg = dataclasses.replace(tconfigs.smoke_config("dbrx-132b"), remat=True,
                              dtype="float32")
    params, _ = tlm.init_params(cfg, device="cpu")
    from repro_torch.launch.train import synthetic_batch
    batch = synthetic_batch(cfg, 2, 16, 0, device="cpu")

    def grad(on_other_thread: bool):
        leaf = params["blocks"]["ffn"]["w_gate"].detach().requires_grad_()
        p = {**params, "blocks": {**params["blocks"], "ffn": {
            **params["blocks"]["ffn"], "w_gate": leaf}}}
        with options(moe_groups=2):
            loss = tlm.loss_fn(p, cfg, batch, q_block=BLOCK, kv_block=BLOCK)
            if not on_other_thread:
                return torch.autograd.grad(loss, [leaf])[0]
        out = []
        th = threading.Thread(
            target=lambda: out.append(torch.autograd.grad(loss, [leaf])[0]))
        th.start()
        th.join(timeout=120)
        assert not th.is_alive() and len(out) == 1
        return out[0]
    assert torch.equal(grad(True), grad(False))
