"""Every arch of the registry at its smoke config, the port against the
JAX package, in two regimes of tolerance:

* ``float32``: the smoke config with ``dtype="float32"``; logits, loss
  and caches within rtol = atol = 1e-4;
* ``bfloat16``: the native smoke config; within rtol = atol = 3e-2, and
  the argmax of the logits agrees at > 0.9 of the positions, as
  ``tests/test_models.py`` holds decode against forward.

The reference draws the params (``jax.random``); ``params_from_reference``
carries them across, so both compute on the same weights.  Each case's
reference and port outputs are computed once, in a module-scoped
fixture: ``forward`` and ``loss_fn`` over B=2, S=16 with blocks of 8 (so
one kv block is fully masked), and 16 teacher-forced ``decode_step``s
from a fresh cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, smoke_config
from repro.models import lm as rlm
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

B, S, BLOCK = 2, 16, 8
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CASES = [(n, r) for r in TOL for n in sorted(ARCHS)]


def make_batch(cfg, rng):
    if cfg.input_kind == "codes":
        toks = rng.integers(0, cfg.vocab, size=(B, S, cfg.n_codebooks))
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}
    if cfg.input_kind == "embeds":
        return {"embeds": rng.normal(0, 0.1, size=(B, S, cfg.d_model))
                .astype(np.float32),
                "positions": np.stack([np.tile(np.arange(S), (B, 1)),
                                       np.tile(np.arange(S) // 2, (B, 1)),
                                       np.tile(np.arange(S) % 5, (B, 1))])
                .astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, size=(B, S))
                .astype(np.int32)}
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def to_jax(batch, cfg):
    return {k: jnp.asarray(v, cfg.dtype) if k == "embeds" else jnp.asarray(v)
            for k, v in batch.items()}


def to_torch(batch, cfg):
    return {k: torch.tensor(v).to(getattr(torch, cfg.dtype))
            if k == "embeds" else torch.tensor(v) for k, v in batch.items()}


def step_batch(batch, pos):
    key = "embeds" if "embeds" in batch else "tokens"
    return {key: batch[key][:, pos:pos + 1]}


def npf(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}-{r}" for n, r in CASES])
def case(request):
    name, regime = request.param
    cfg = smoke_config(name)
    if regime == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    rp, rax = rlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), cfg,
        device="cpu")
    batch = make_batch(cfg, np.random.default_rng(0))
    jb, tb = to_jax(batch, cfg), to_torch(batch, cfg)
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    out = {"cfg": cfg, "regime": regime, "rp": rp, "rax": rax}
    out["r_fwd"] = npf(jax.jit(lambda p, b: rlm.forward(p, cfg, b, **kw))(
        rp, jb))
    out["r_loss"] = float(jax.jit(lambda p, b: rlm.loss_fn(p, cfg, b, **kw))(
        rp, jb))
    out["r_cache0"] = rlm.init_cache(cfg, B, S)
    dec = jax.jit(lambda p, c, b, pos: rlm.decode_step(p, cfg, c, b, pos))
    cache, steps = out["r_cache0"], []
    for pos in range(S):
        lg, cache = dec(rp, cache, step_batch(jb, pos), jnp.int32(pos))
        steps.append(npf(lg))
    out["r_steps"], out["r_cache"] = steps, cache
    with torch.inference_mode():
        out["t_fwd"] = npf(tlm.forward(tp, cfg, tb, **kw))
        out["t_loss"] = float(tlm.loss_fn(tp, cfg, tb, **kw))
        out["t_cache0"] = tlm.init_cache(cfg, B, S, device="cpu")
        cache = {k: v.clone() for k, v in out["t_cache0"].items()}
        steps = []
        for pos in range(S):
            lg, cache2 = tlm.decode_step(tp, cfg, cache, step_batch(tb, pos),
                                         pos)
            assert cache2 is cache
            steps.append(npf(lg))
    out["t_steps"], out["t_cache"] = steps, cache
    return out


def test_init_params_matches_reference_tree(case):
    cfg = case["cfg"]
    tp, tax = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                              device="cpu")
    assert tax == case["rax"]
    got = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)[6:])
           for p, x in jax.tree_util.tree_leaves_with_path(tp)}
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(case["rp"])}
    assert got == want


def test_forward_matches_reference(case):
    tol = TOL[case["regime"]]
    got, want = case["t_fwd"], case["r_fwd"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree == 1.0 if case["regime"] == "float32" else agree > 0.9


def test_loss_matches_reference(case):
    tol = TOL[case["regime"]]
    assert np.isfinite(case["t_loss"]) and case["t_loss"] > 0
    assert abs(case["t_loss"] - case["r_loss"]) <= tol * (
        1 + abs(case["r_loss"]))


def test_init_cache_matches_reference(case):
    got = {k: (tuple(v.shape), str(v.dtype)[6:])
           for k, v in case["t_cache0"].items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in case["r_cache0"].items()}
    assert got == want
    assert all(not v.any() for v in case["t_cache0"].values())


def test_decode_steps_match_reference(case):
    tol = TOL[case["regime"]]
    for pos, (g, w) in enumerate(zip(case["t_steps"], case["r_steps"])):
        assert g.shape == w.shape, pos
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"step {pos}")
    for k, w in case["r_cache"].items():
        np.testing.assert_allclose(npf(case["t_cache"][k]), npf(w),
                                   rtol=tol, atol=tol, err_msg=k)
