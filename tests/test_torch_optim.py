"""The port's AdamW (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same float32 inputs:

* random trees of nested dicts (keys out of sorted order, several
  shapes) over 5 steps, with and without ``compress_grads``: params,
  moments, the error feedback and the step within 1e-6, and the int8
  codes and scales of ``compress_int8`` equal;
* ``tests/test_dist.py``'s two AdamW tests, as two cases of one
  parametrised test: each package runs the test's loop on the same
  gradients, the two trajectories agree within 1e-6, and the port meets
  the original test's assertion;
* rounding half to even (``torch.round`` and ``jnp.round``), the warmup
  schedule, the state's keys and dtypes, and bfloat16 params (moments in
  float32, the update cast back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ropt
from repro.optim import adamw as radamw
from repro_torch import optim as topt
from repro_torch.optim import adamw as tadamw

TOL = 1e-6


def random_tree(rng):
    return {"zeta": rng.normal(size=(5, 7)).astype(np.float32),
            "alpha": {"w": rng.normal(size=(3, 4, 2)).astype(np.float32),
                      "b": rng.normal(size=(6,)).astype(np.float32)},
            "mid": rng.normal(size=(1,)).astype(np.float32)}


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def th(tree):
    return jax.tree.map(torch.tensor, tree)


def leaves_np(tree):
    """Leaves in the reference's order, as numpy (either package)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    return [np.asarray(tree, np.float32)]


def assert_trees_close(got, want, tol=TOL):
    g, w = leaves_np(got), leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(compress):
    rng = np.random.default_rng(1)
    params = random_tree(rng)
    rcfg = ropt.AdamWConfig(lr=1e-2, warmup_steps=3, compress_grads=compress)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=3, compress_grads=compress)
    rp, tp = jx(params), th(params)
    rs, ts = ropt.adamw_init(rp), topt.adamw_init(tp)
    re = te = None
    for _ in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3)
                         .astype(np.float32), params)
        rp, rs, re = ropt.adamw_update(rcfg, rp, jx(g), rs, re)
        tp, ts, te = topt.adamw_update(tcfg, tp, th(g), ts, te)
        assert_trees_close(tp, rp)
        assert_trees_close(ts["mu"], rs["mu"])
        assert_trees_close(ts["nu"], rs["nu"])
        assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
        assert int(ts["step"]) == int(rs["step"])
        if compress:
            assert_trees_close(te, re)
        else:
            assert te is None and re is None
    assert sorted(ts) == sorted(rs) == ["mu", "nu", "step"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_codes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for g in (rng.normal(size=(257,)).astype(np.float32),
              (rng.integers(-4, 5, size=(64,)) * 0.5).astype(np.float32),
              np.zeros((8,), np.float32)):
        rq, rscale = radamw.compress_int8(jnp.asarray(g))
        tq, tscale = tadamw.compress_int8(torch.tensor(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert float(tscale) == float(rscale)
        np.testing.assert_array_equal(
            tadamw.decompress_int8(tq, tscale).numpy(),
            np.asarray(radamw.decompress_int8(rq, rscale)))


def test_round_half_to_even_in_both_packages():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 126.5],
                 np.float32)
    want = np.array([-2, -2, -0, 0, 2, 2, 4, 126], np.float32)
    np.testing.assert_array_equal(torch.round(torch.tensor(x)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(x))),
                                  want)
    # a gradient whose codes fall on halves: g / scale = k + 0.5
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5], np.float32)
    tq, _ = tadamw.compress_int8(torch.tensor(g))
    rq, _ = radamw.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(tq.numpy(), [127, 0, 2, 2, 0, -4])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))


@pytest.mark.parametrize("step", [0, 1, 7, 100, 101, 5000])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100)
    got = tadamw._schedule(topt.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    want = radamw._schedule(ropt.AdamWConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_bf16_params_keep_their_dtype_and_float32_moments():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    g = rng.normal(size=(16, 8)).astype(np.float32)
    rp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.tensor(w).to(torch.bfloat16)}
    cfg = dict(lr=1e-2, warmup_steps=1)
    rs, ts = ropt.adamw_init(rp), topt.adamw_init(tp)
    assert ts["mu"]["w"].dtype == ts["nu"]["w"].dtype == torch.float32
    rp, rs, _ = ropt.adamw_update(ropt.AdamWConfig(**cfg), rp,
                                  {"w": jnp.asarray(g, jnp.bfloat16)}, rs)
    tp, ts, _ = topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                                  {"w": torch.tensor(g).to(torch.bfloat16)},
                                  ts)
    assert tp["w"].dtype == torch.bfloat16
    assert_trees_close(ts["mu"], rs["mu"])
    # one bf16 rounding of the same float32 value, or its neighbour
    diff = np.abs(tp["w"].float().numpy()
                  - np.asarray(rp["w"], np.float32))
    assert (diff <= np.abs(w) * 2.0 ** -7).all()
    assert (diff == 0).mean() > 0.99


def _quadratic(opt, adamw_init, adamw_update, to_arr, np_of):
    """test_dist.py's test_adamw_converges_quadratic on one package."""
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": to_arr(np.ones((4,), np.float32) * 5.0)}
    state = adamw_init(params)
    traj = []
    for _ in range(200):
        grads = {"w": 2 * params["w"]}        # d/dw (w^2)
        params, state, _ = adamw_update(cfg, params, grads, state)
        traj.append(np_of(params["w"]))
    return np.stack(traj), None


def _error_feedback(opt, adamw_init, adamw_update, to_arr, np_of):
    """test_dist.py's test_grad_compression_error_feedback on one
    package, the error feedback carried by hand."""
    cfg = opt.AdamWConfig(lr=1e-2, compress_grads=True, warmup_steps=1)
    params = {"w": to_arr(np.zeros((64,), np.float32))}
    state = adamw_init(params)
    rng = np.random.default_rng(0)
    efb = None
    traj = []
    for _ in range(50):
        g = {"w": to_arr((rng.normal(0, 1, 64) + 0.05).astype(np.float32))}
        params, state, efb = adamw_update(cfg, params, g, state, efb)
        traj.append(np_of(params["w"]))
    return np.stack(traj), np_of(efb["w"])


@pytest.mark.parametrize("mirror", [_quadratic, _error_feedback],
                         ids=["converges_quadratic", "error_feedback"])
def test_dist_adamw_tests_mirrored(mirror):
    want, want_efb = mirror(ropt, ropt.adamw_init, ropt.adamw_update,
                            jnp.asarray, lambda a: np.asarray(a))
    got, got_efb = mirror(topt, topt.adamw_init, topt.adamw_update,
                          torch.tensor, lambda t: t.numpy().copy())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if mirror is _quadratic:
        assert float(np.abs(got[-1]).max()) < 0.2
    else:
        np.testing.assert_allclose(got_efb, want_efb, rtol=0, atol=TOL)
        assert float(got[-1].mean()) < 0       # moved against +0.05 bias
