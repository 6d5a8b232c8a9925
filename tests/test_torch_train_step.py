"""The port's train step (``repro_torch.launch.steps.make_train_step``,
gradients through ``torch.autograd``) against the reference's (jitted
``jax.value_and_grad`` and ``adamw_update``), for every arch of the registry at its smoke
config in float32 (B=2, S=16, blocks of 8), on the reference's weights
(``params_from_reference``) and batches (``repro.launch.train.
synthetic_batch``, embeds in float32):

* the loss and every step-1 gradient leaf within 1e-4 (the loss of
  (1 + |loss|), a leaf of its max |grad|), as ``test_torch_lm_archs``
  holds the forward;
* the params after 3 steps of ``AdamWConfig(lr=1e-3, warmup_steps=1)``
  at most ``2 * lr * 3`` apart, and all but 1e-4 of the elements within
  1e-5.  The bound is Adam's: an element whose gradient lies within
  float32 noise of zero (|g| near ``eps``) may take the other normalised
  update, which moves it by up to ``lr`` a step either way; every other
  element follows its gradient's sign and agrees to rounding.

Also: the port's remat policies ("none", "full", "dots") give the same
gradients bit for bit, "dots" saving the 2-D products and recomputing
the batched ones; and the reference's two faults on this path, pinned:
its SSD gradients are not finite at S=128 (``models/ssm.py``'s ``exp``
before the mask), and its ``make_train_step`` drops the error feedback
of ``compress_grads``.
"""

import dataclasses
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS, smoke_config
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.optim import AdamWConfig as RAdamW
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import adamw_init as tadamw_init

torch.set_num_threads(1)

B, S, BLOCK, N_STEPS = 2, 16, 8, 3
TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1)
PARAM_BOUND = 2 * OPT["lr"] * N_STEPS
PARAM_CLOSE, PARAM_SHARE = 1e-5, 1e-4


def f32(name):
    return dataclasses.replace(smoke_config(name), dtype="float32")


def carried(cfg):
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), cfg,
        device="cpu")
    return rp, tp


def batches(cfg, b, s, n):
    """The reference's batches for steps 0..n-1, embeds in float32, as
    (jax, torch) pairs of the same values."""
    out = []
    for step in range(n):
        nb = {k: np.asarray(v, np.float32 if k == "embeds" else None)
              for k, v in rtrain.synthetic_batch(cfg, b, s, step).items()}
        out.append(({k: jnp.asarray(v) for k, v in nb.items()},
                    {k: torch.from_numpy(v.copy()) for k, v in nb.items()}))
    return out


def leaves(tree):
    """Leaves as float32 numpy, in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


def leaf_err(got, want) -> float:
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    """The reference's step is ``jax.value_and_grad`` of ``lm.loss_fn``
    and then ``adamw_update`` (``repro/launch/steps.py:13-21``); the two
    calls are jitted apart here, so that one compile of the gradient
    serves the step-1 gradients and all 3 steps."""
    cfg = f32(request.param)
    rp, tp = carried(cfg)
    data = batches(cfg, B, S, N_STEPS)
    ropt, topt = RAdamW(**OPT), TAdamW(**OPT)
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    rgrad = jax.jit(jax.value_and_grad(
        lambda p, b: rlm.loss_fn(p, cfg, b, **kw)))
    rupdate = jax.jit(lambda p, g, st: radamw_update(ropt, p, g, st)[:2])
    rstate = {"params": rp, "opt": radamw_init(rp)}
    tstate = {"params": tp, "opt": tadamw_init(tp)}
    tfn = tsteps.make_train_step(cfg, topt, **kw)
    out = {"name": request.param, "r_loss": [], "t_loss": []}
    out["t_l0"], out["t_g0"] = tsteps.loss_and_grads(tp, cfg, data[0][1],
                                                     **kw)
    for i, (jb, tb) in enumerate(data):
        rl, rg = rgrad(rstate["params"], jb)
        rp_new, ropt_new = rupdate(rstate["params"], rg, rstate["opt"])
        rstate = {"params": rp_new, "opt": ropt_new}
        tstate, tl = tfn(tstate, tb)
        if i == 0:
            out["r_g0"] = rg
        out["r_loss"].append(float(rl))
        out["t_loss"].append(float(tl))
    out["r_state"], out["t_state"] = rstate, tstate
    return out


def test_train_step_loss_and_grads_match_reference(case):
    want = case["r_loss"][0]
    assert float(case["t_l0"]) == case["t_loss"][0]
    assert abs(case["t_loss"][0] - want) <= TOL * (1 + abs(want))
    got, exp = leaves(case["t_g0"]), leaves(case["r_g0"])
    assert len(got) == len(exp)
    for g, w in zip(got, exp):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert leaf_err(g, w) <= TOL


def test_train_step_params_after_three_steps_match_reference(case):
    for got, want in zip(case["t_loss"], case["r_loss"]):
        assert abs(got - want) <= TOL * (1 + abs(want))
    rs, ts = case["r_state"], case["t_state"]
    assert sorted(ts) == sorted(rs) == ["opt", "params"]
    assert int(ts["opt"]["step"]) == int(rs["opt"]["step"]) == N_STEPS
    over = n = 0
    for g, w in zip(leaves(ts["params"]), leaves(rs["params"])):
        d = np.abs(g - w)
        assert d.max() <= PARAM_BOUND
        over += int((d > PARAM_CLOSE).sum())
        n += d.size
    assert over <= PARAM_SHARE * n
    for key in ("mu", "nu"):
        for g, w in zip(leaves(ts["opt"][key]), leaves(rs["opt"][key])):
            assert np.isfinite(g).all() and g.shape == w.shape


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_remat_policies_give_the_same_gradients(name):
    base = f32(name)
    _, tp = carried(base)
    tb = batches(base, B, S, 1)[0][1]
    got = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=policy != "none",
                                  remat_policy=policy)
        with _OpCount() as ops:
            loss, grads = tsteps.loss_and_grads(tp, cfg, tb, q_block=BLOCK,
                                                kv_block=BLOCK)
        got[policy] = (loss, grads, ops.n.get(torch.ops.aten.mm.default, 0),
                       ops.n.get(torch.ops.aten.bmm.default, 0))
    for policy in ("full", "dots"):
        assert torch.equal(got[policy][0], got["none"][0])
        for a, b in zip(leaves(got[policy][1]), leaves(got["none"][1])):
            np.testing.assert_array_equal(a, b)
    mm = {p: v[2] for p, v in got.items()}
    bmm = {p: v[3] for p, v in got.items()}
    # "full" runs every block's products again; "dots" only the batched
    assert mm["dots"] == mm["none"] < mm["full"]
    assert bmm["none"] < bmm["dots"] == bmm["full"]


# ---------------------------------------------------------------------
# the reference's faults on the training path
# ---------------------------------------------------------------------

_SSD_LINE = ("L = jnp.where(causal[None, None, :, :, None], jnp.exp(diff), "
             "0.0)")
_SSD_FIXED = ("L = jnp.exp(jnp.where(causal[None, None, :, :, None], diff, "
              "-jnp.inf))")


def _fixed_ssd_forward():
    """``repro.models.ssm.ssd_forward`` with its mask taken before the
    ``exp`` (the port's line)."""
    src = inspect.getsource(rssm.ssd_forward)
    assert src.count(_SSD_LINE) == 1
    ns = dict(vars(rssm))
    exec(compile(src.replace(_SSD_LINE, _SSD_FIXED), rssm.__file__, "exec"),
         ns)
    return ns["ssd_forward"]


def _ref_loss_and_grads(cfg, rp, jb):
    f = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, cfg, jb, q_block=128, kv_block=128)))
    loss, grads = f(rp)
    return float(loss), grads


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-7b"])
def test_reference_ssd_gradient_fault(name, monkeypatch):
    """At S=128 (``launch/train.py``'s default ``--seq``, one full SSD
    chunk) the reference's loss is finite and some of its gradients are
    not: above the diagonal ``exp(diff)`` overflows, and ``where``'s
    backward multiplies that inf by 0.  The port's gradients are finite
    and equal those of the reference with the mask taken first, whose
    loss is the reference's to the bit."""
    cfg = f32(name)
    rp, tp = carried(cfg)
    jb, tb = batches(cfg, 2, 128, 1)[0]
    loss, grads = _ref_loss_and_grads(cfg, rp, jb)
    bad = sum(not np.isfinite(g).all() for g in leaves(grads))
    assert np.isfinite(loss) and bad > 0
    fixed = _fixed_ssd_forward()
    monkeypatch.setattr(rssm, "ssd_forward", fixed)
    monkeypatch.setattr(rlm, "ssd_forward", fixed)
    floss, fgrads = _ref_loss_and_grads(cfg, rp, jb)
    assert floss == loss
    tloss, tgrads = tsteps.loss_and_grads(tp, cfg, tb, q_block=128,
                                          kv_block=128)
    assert abs(float(tloss) - floss) <= TOL * (1 + abs(floss))
    for g, w in zip(leaves(tgrads), leaves(fgrads)):
        assert np.isfinite(g).all() and np.isfinite(w).all()
        assert leaf_err(g, w) <= TOL


def _efb_run(steps_mod, to_arr, init, cfg, n=50):
    """``n`` steps of ``steps_mod.make_train_step`` on a linear loss
    whose gradient is the batch's ``g`` (``test_dist.py``'s persistent
    +0.05 bias), so only the step's handling of the optimizer shows."""
    params = {"w": to_arr(np.zeros((64,), np.float32))}
    state = {"params": params, "opt": init(params)}
    step = steps_mod.make_train_step(None, cfg)
    rng = np.random.default_rng(0)
    traj = []
    for _ in range(n):
        g = (rng.normal(0, 1, 64) + 0.05).astype(np.float32)
        state, _ = step(state, {"g": to_arr(g)})
        traj.append(np.asarray(state["params"]["w"], np.float32).copy())
    return np.stack(traj), state


def _ref_adamw_loop(cfg, carry: bool, n=50):
    params = {"w": jnp.zeros((64,))}
    state = radamw_init(params)
    rng = np.random.default_rng(0)
    efb = None
    traj = []
    for _ in range(n):
        g = {"w": jnp.asarray(rng.normal(0, 1, 64) + 0.05, jnp.float32)}
        params, state, new_efb = radamw_update(cfg, params, g, state, efb)
        efb = new_efb if carry else None
        traj.append(np.asarray(params["w"]))
    return np.stack(traj), efb


def test_reference_make_train_step_drops_error_feedback(monkeypatch):
    """The reference's step throws ``adamw_update``'s error feedback away
    (``_`` in ``steps.py``): with ``compress_grads`` it equals the
    update loop that never carries it, not the one that does."""
    monkeypatch.setattr(rsteps, "lm", types.SimpleNamespace(
        loss_fn=lambda p, cfg, b, **kw: jnp.sum(p["w"] * b["g"])))
    cfg = RAdamW(lr=1e-2, compress_grads=True, warmup_steps=1)
    got, state = _efb_run(rsteps, jnp.asarray, radamw_init, cfg)
    dropped, _ = _ref_adamw_loop(cfg, carry=False)
    carried_, _ = _ref_adamw_loop(cfg, carry=True)
    np.testing.assert_allclose(got, dropped, rtol=0, atol=1e-6)
    assert np.abs(got - carried_).max() > 1e-3
    assert sorted(state) == ["opt", "params"]


def test_port_train_step_carries_error_feedback(monkeypatch):
    """The port's step carries the error feedback in the state under
    ``"error_fb"`` and equals the reference's update loop that carries
    it by hand (``test_dist.py``); without ``compress_grads`` the state
    keeps the reference's keys."""
    monkeypatch.setattr(tsteps, "lm", types.SimpleNamespace(
        loss_fn=lambda p, cfg, b, **kw: torch.sum(p["w"] * b["g"])))
    cfg = TAdamW(lr=1e-2, compress_grads=True, warmup_steps=1)
    got, state = _efb_run(tsteps, torch.tensor, tadamw_init, cfg)
    want, efb = _ref_adamw_loop(
        RAdamW(lr=1e-2, compress_grads=True, warmup_steps=1), carry=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(state["error_fb"]["w"].numpy(),
                               np.asarray(efb["w"]), rtol=0, atol=1e-6)
    assert float(got[-1].mean()) < 0       # moved against +0.05 bias
    _, plain = _efb_run(tsteps, torch.tensor, tadamw_init,
                        TAdamW(lr=1e-2, warmup_steps=1), n=2)
    assert sorted(plain) == ["opt", "params"]
