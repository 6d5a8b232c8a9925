"""The LM scaffolding's small parts in the port against the JAX package:
the configs, the mesh helpers, the layer functions, the weight
conversion and the ``nn.Module`` view.

Same inputs from a seed through both; float32 elementwise layers within
1e-6, the bfloat16 ones within one bfloat16 rounding step.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch.dist import api as tdist
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_reference, params_to_numpy

torch.set_num_threads(1)

NAMES = sorted(rconfigs.ARCHS)


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a)).to(dtype or torch.float32)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------ configs ------------------------------

def test_arch_registry_equal():
    assert sorted(tconfigs.ARCHS) == NAMES
    assert [c.name for c in tconfigs.ARCHS.values()] == \
        [c.name for c in rconfigs.ARCHS.values()]
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-2")


@pytest.mark.parametrize("name", NAMES)
def test_arch_config_equal(name):
    for fn in ("get_arch", "smoke_config"):
        tc = getattr(tconfigs, fn)(name)
        rc = getattr(rconfigs, fn)(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        assert tc.param_count() == rc.param_count()
        assert tc.active_param_count() == rc.active_param_count()
        assert tc.is_attention_free == rc.is_attention_free
        for s in rconfigs.SHAPES:
            assert tconfigs.shape_applicable(tc, tconfigs.SHAPES[s]) == \
                rconfigs.shape_applicable(rc, rconfigs.SHAPES[s])


# ---------------------------- mesh helpers ----------------------------

def test_options_nest_and_restore():
    assert tdist.get_option("moe_groups") is None
    assert tdist.get_option("moe_groups", 3) == 3
    with tdist.options(moe_groups=2, seq_parallel=True):
        assert tdist.get_option("moe_groups") == 2
        with tdist.options(moe_groups=4):
            assert tdist.get_option("moe_groups") == 4
            assert tdist.get_option("seq_parallel") is True
        assert tdist.get_option("moe_groups") == 2
        seen = []
        th = threading.Thread(target=lambda: seen.append(
            tdist.get_option("moe_groups")))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive() and seen == [None]   # thread-local
    assert tdist.get_option("moe_groups") is None
    with pytest.raises(ZeroDivisionError):
        with tdist.options(moe_ep=True):
            1 / 0
    assert tdist.get_option("moe_ep") is None


def test_constrain_identity_without_mesh_raises_under_one():
    """Without a mesh ``constrain`` returns the same object; under the
    1-rank gloo mesh it redistributes a DTensor to the placements the
    names give, and a plain tensor raises ``TypeError``."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    x = torch.arange(6.0).reshape(2, 3)
    assert tdist.current_mesh() is None
    assert tdist.constrain(x, "batch", None) is x
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with tdist.active_mesh(mesh) as m:
            assert tdist.current_mesh() is m is mesh
            assert tdist.batch_mesh_axes(mesh) == ("data",)
            with tdist.options(dp_all=True):
                assert tdist.batch_mesh_axes(mesh) == ("data", "model")
            xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            y = tdist.constrain(xd, "batch", "model")
            assert isinstance(y, DTensor)
            assert y.placements == (Shard(0), Shard(1))
            z = tdist.constrain(y, None, None)
            assert z.placements == (Replicate(), Replicate())
            assert torch.equal(z.full_tensor(), x)
            with pytest.raises(TypeError, match="DTensor"):
                tdist.constrain(x, "batch", None)
        assert tdist.current_mesh() is None
        assert tdist.constrain(x, "batch", None) is x
    finally:
        dist.destroy_process_group()


# ------------------------------ layers ------------------------------

@pytest.fixture(scope="module")
def acts():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(2, 5, 3, 16)).astype(np.float32),
            "h": rng.normal(size=(2, 5, 32)).astype(np.float32),
            "w": rng.normal(1, 0.1, size=(32,)).astype(np.float32),
            "wg": rng.normal(0, 0.2, size=(32, 48)).astype(np.float32),
            "wu": rng.normal(0, 0.2, size=(32, 48)).astype(np.float32),
            "wd": rng.normal(0, 0.2, size=(48, 32)).astype(np.float32),
            "pos": rng.integers(0, 4096, size=(2, 5)).astype(np.int32),
            "pos3": rng.integers(0, 512, size=(3, 2, 5)).astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_functions(acts, dtype):
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    # f32 within 1e-6 (relative, the rope angles reach 4096 rad); bf16
    # within about one rounding step of the output
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    a = acts
    cases = [
        (tlayers.rms_norm(t(a["h"], tdt), t(a["w"], tdt)),
         rlayers.rms_norm(j(a["h"], jdt), j(a["w"], jdt))),
        (tlayers.swiglu(*(t(a[k], tdt) for k in ("h", "wg", "wu", "wd"))),
         rlayers.swiglu(*(j(a[k], jdt) for k in ("h", "wg", "wu", "wd")))),
        (tlayers.sq_relu_ffn(*(t(a[k], tdt) for k in ("h", "wu", "wd"))),
         rlayers.sq_relu_ffn(*(j(a[k], jdt) for k in ("h", "wu", "wd")))),
        (tlayers.apply_rope(t(a["x"], tdt), t(a["pos"], torch.int32), 1e6),
         rlayers.apply_rope(j(a["x"], jdt), j(a["pos"], jnp.int32), 1e6)),
        (tlayers.apply_mrope(t(a["x"], tdt), t(a["pos3"], torch.int32)),
         rlayers.apply_mrope(j(a["x"], jdt), j(a["pos3"], jnp.int32))),
    ]
    for got, want in cases:
        assert got.dtype == tdt and got.shape == tuple(want.shape)
        close(got, want, tol)


def test_rope_tables_and_sections():
    for D, theta in ((64, 1e6), (128, 1e4), (16, 5e5)):
        np.testing.assert_array_equal(tlayers.rope_freqs(D, theta),
                                      rlayers.rope_freqs(D, theta))
    assert tlayers.MROPE_SECTIONS == rlayers.MROPE_SECTIONS
    for half in range(3, 97):
        assert tlayers.mrope_sections(half) == rlayers.mrope_sections(half)


def test_dense_init_draws_float32_then_casts():
    g = torch.Generator("cpu").manual_seed(5)
    a = tlayers.dense_init(g, (64, 512), torch.bfloat16, "cpu")
    g = torch.Generator("cpu").manual_seed(5)
    f = torch.randn((64, 512), generator=g, dtype=torch.float32) * 0.02
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, f.to(torch.bfloat16))
    assert abs(float(f.std()) - 0.02) < 1e-3
    m = tlayers.dense_init(None, (3, 4), torch.float32, "meta", scale=0.1)
    assert m.is_meta and m.shape == (3, 4)


# ------------------------- weights carried across -------------------------

@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "dbrx-132b", "zamba2-7b",
                                  "musicgen-large"])
def test_params_from_reference_round_trip(name):
    cfg = rconfigs.smoke_config(name)
    rp, rax = rlm.init_params(cfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), rp)
    got = params_from_reference(tree, cfg, device="cpu")
    want, tax = tlm.init_params(cfg, device="meta")
    assert tax == rax
    flat_t = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(rp))
    assert [p for p, _ in flat_t] == list(flat_w)
    for path, x in flat_t:
        assert x.dtype == flat_w[path].dtype and x.shape == flat_w[path].shape
        assert str(x.dtype).split(".")[-1] == str(flat_r[path].dtype)
    back = params_to_numpy(got)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_params_from_reference_raises_on_mismatch():
    cfg = rconfigs.smoke_config("qwen1.5-0.5b")
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), rp)
    bad = dict(tree, head=tree["head"][:, :-1])
    with pytest.raises(ValueError, match=r"params\['head'\]: shape"):
        params_from_reference(bad, cfg, device="cpu")
    bad = dict(tree, blocks=dict(tree["blocks"]))
    bad["blocks"]["attn"] = {k: v for k, v in tree["blocks"]["attn"].items()
                             if k != "bq"}
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(dict(tree, extra=np.zeros(3)), cfg,
                              device="cpu")
    other = rconfigs.smoke_config("internlm2-1.8b")   # no QKV bias
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tree, other, device="cpu")


# ---------------------------- nn.Module view ----------------------------

def test_language_model_module():
    cfg = dataclasses.replace(tconfigs.smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    gen = torch.Generator("cpu").manual_seed(1)
    m = tlm.LanguageModel(cfg, gen, device="cpu")
    ref, axes = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(1),
                                device="cpu")
    assert m.axes == axes
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    sd = m.state_dict()
    assert len(sd) == len(leaves) == len(list(m.parameters()))
    for path, x in leaves.items():
        key = "tree." + ".".join(p.key for p in path)
        assert torch.equal(sd[key], x)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 8)))
    with torch.inference_mode():
        got = m({"tokens": toks}, q_block=4, kv_block=4)
        want = tlm.forward(ref, cfg, {"tokens": toks}, q_block=4, kv_block=4)
    assert torch.equal(got, want)
    # the params tree holds the module's own parameters: an optimizer step
    # on the module moves what the functions see
    opt = torch.optim.SGD(m.parameters(), lr=1.0)
    loss = m.loss({"tokens": toks, "labels": toks}, q_block=4, kv_block=4)
    loss.backward()
    opt.step()
    assert not torch.equal(m.params["head"], ref["head"])
    assert m.params["head"].data_ptr() == m.tree.head.data_ptr()
    # .to() moves what the functions see
    assert m.to(torch.float64).params["head"].dtype == torch.float64
