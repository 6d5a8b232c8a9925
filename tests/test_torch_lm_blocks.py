"""The port's attention, MoE and SSD blocks against the JAX package, and
the port's mirrors of the reference's own block tests.

Same numpy inputs from a seed, the same params (drawn by the reference,
carried across as numpy); float32 within 1e-5 unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.dist.api import options as roptions
from repro_torch.dist.api import options as toptions
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)


def to_t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a, np.float32)),
                        tree)


def npf(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def f32(name, **kw):
    return dataclasses.replace(smoke_config(name), dtype="float32", **kw)


# ------------------------------ attention ------------------------------

@pytest.mark.parametrize("H,KH,S,qb,kb", [
    (4, 2, 64, 16, 16),      # GQA, 4x4 blocks, 6 fully masked
    (4, 4, 32, 8, 16),       # MHA, q blocks smaller than kv blocks
    (8, 1, 48, 16, 8),       # MQA, kv blocks smaller than q blocks
    (4, 2, 24, 512, 512),    # one block (the sizes clip to S)
])
def test_flash_attention_vs_reference(H, KH, S, qb, kb):
    rng = np.random.default_rng(S + H)
    B, D = 2, 16
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (H, KH, KH))
    want = rattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_block=qb, kv_block=kb)
    got = tattn.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), q_block=qb, kv_block=kb)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(npf(got), npf(want), rtol=1e-5, atol=1e-5)
    nc = rattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False, q_block=qb,
                               kv_block=kb)
    gc = tattn.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=False, q_block=qb,
                               kv_block=kb)
    np.testing.assert_allclose(npf(gc), npf(nc), rtol=1e-5, atol=1e-5)


def test_flash_attention_vs_naive():
    """Mirror of tests/test_models.py::test_flash_attention_vs_naive."""
    rng = np.random.default_rng(0)
    B, S, H, D, KH = 2, 64, 4, 16, 2
    q = torch.as_tensor(rng.normal(size=(B, S, H, D)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(B, S, KH, D)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(B, S, KH, D)), dtype=torch.float32)
    o = tattn.flash_attention(q, k, v, q_block=16, kv_block=16)
    G = H // KH
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(D)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
    s = torch.where(mask[None, None], s, -1e30)
    on = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    np.testing.assert_allclose(npf(o), npf(on), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "internlm2-1.8b",
                                  "qwen2-vl-72b"])
def test_attn_forward_and_decode_vs_reference(name):
    cfg = f32(name)
    rp, _ = rattn.init_attn(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = to_t(rp)
    rng = np.random.default_rng(1)
    B, S, Smax = 2, 8, 12
    x = rng.normal(0, 1, size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if cfg.rope == "mrope":
        pos = np.stack([pos, pos // 2, pos % 3])
    ro, (rk, rv) = rattn.attn_forward(rp, jnp.asarray(x), cfg,
                                      jnp.asarray(pos), q_block=4,
                                      kv_block=4)
    to, (tk, tv) = tattn.attn_forward(tp, torch.as_tensor(x), cfg,
                                      torch.as_tensor(pos), q_block=4,
                                      kv_block=4)
    for g, w in ((to, ro), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(npf(g), npf(w), rtol=1e-5, atol=1e-5)
    # decode: every position, then two past the end of the cache, where
    # dynamic_update_slice clamps the write to Smax - 1
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    c0 = rng.normal(size=(B, Smax, KH, hd)).astype(np.float32)
    rck, rcv = jnp.asarray(c0), jnp.asarray(-c0)
    tck, tcv = torch.tensor(c0), torch.tensor(-c0)
    ptr = tck.data_ptr()
    for p in list(range(Smax)) + [Smax, Smax + 5]:
        xt = x[:, p % S:p % S + 1]
        ro, rck, rcv = rattn.attn_decode(rp, jnp.asarray(xt), rck, rcv,
                                         jnp.int32(p), cfg)
        to, tck2, tcv2 = tattn.attn_decode(tp, torch.as_tensor(xt), tck,
                                           tcv, p, cfg)
        assert tck2 is tck and tcv2 is tcv and tck.data_ptr() == ptr
        np.testing.assert_allclose(npf(to), npf(ro), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(npf(tck), npf(rck), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(npf(tcv), npf(rcv), rtol=1e-6, atol=1e-6)
        # the slots past pos still hold what they held
        np.testing.assert_array_equal(npf(tck)[:, p + 1:], c0[:, p + 1:])
        if p == Smax - 1:
            full = tck.clone()
    # the clamped writes landed in the last slot, nowhere else
    assert torch.equal(tck[:, :-1], full[:, :-1])
    assert not torch.equal(tck[:, -1], full[:, -1])


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "internlm2-1.8b",
                                  "qwen2-vl-72b", "dbrx-132b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_without_a_mesh_is_the_plain_composition(name, dtype):
    """With no mesh ``attn_forward`` and ``attn_decode`` return the same
    bits as the plain composition of their parts (project, rotate,
    attend, ``o``): the split over the model axis leaves them as they
    were."""
    cfg = f32(name)
    assert tattn._head_axis(cfg, None) is None
    assert tattn._kv_split(cfg, None) is None
    gen = torch.Generator().manual_seed(3)
    p, _ = tattn.init_attn(gen, cfg, dtype, "cpu")
    B, S, Smax = 2, 8, 8
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(dtype)
    pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    if cfg.rope == "mrope":
        pos = torch.stack([pos, pos // 2, pos % 3])
    o, (k, v) = tattn.attn_forward(p, x, cfg, pos, q_block=4, kv_block=4)
    q2, k2, v2 = tattn._heads(*tattn._project(p, x, cfg), pos, cfg)
    o2 = tattn.flash_attention(q2, k2, v2, q_block=4, kv_block=4)
    assert torch.equal(o, o2.reshape(B, S, -1) @ p["wo"])
    assert torch.equal(k, k2) and torch.equal(v, v2)
    shape = (B, Smax, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)
    ck2, cv2 = ck.clone(), cv.clone()
    for t in range(Smax):
        xt = x[:, t:t + 1]
        o, _, _ = tattn.attn_decode(p, xt, ck, cv, t, cfg)
        pt = torch.full((B, 1), t, dtype=torch.int32)
        if cfg.rope == "mrope":
            pt = pt.expand(3, B, 1)
        q2, k2, v2 = tattn._heads(*tattn._project(p, xt, cfg), pt, cfg)
        ck2[:, t], cv2[:, t] = k2[:, 0], v2[:, 0]
        o2 = tattn._decode_core(q2, ck2, cv2, t, dtype) @ p["wo"]
        assert torch.equal(o, o2) and torch.equal(ck, ck2)


@pytest.mark.parametrize("H,KH,m", [
    (48, 8, 16),     # dbrx-132b and the 72-340B configs: 3 heads a
                     # rank, two ranks on a KV head
    (4, 2, 4),       # the smoke configs on a 4-wide model axis
    (8, 2, 8),       # one head a rank, 4 ranks on a KV head
    (48, 12, 8),     # 6 heads a rank over a KV head and a half: one KV
                     # head a query head
    (16, 8, 2),      # the KV heads divide: whole KV heads a rank
    (40, 8, 16),     # llama4-scout: 3 heads on ranks 0-7, 2 on 8-15,
                     # a block over one KV head or across two
    (6, 2, 4),       # 2, 2, 1, 1: the uneven smoke split
    (5, 1, 3),       # 2, 2, 1 over one KV head
])
def test_each_rank_reads_the_kv_heads_of_its_query_heads(H, KH, m):
    """Attention split by query heads over ``m`` ranks (``_head_block``:
    even, or one head more on the first ``H % m`` ranks), each with the
    KV heads ``_my_kv`` cuts for it, put back together, equals attention
    with every head, forward and decode."""
    cfg = dataclasses.replace(f32("qwen1.5-0.5b"), n_heads=H, n_kv_heads=KH)
    rng = np.random.default_rng(H + KH + m)
    B, S, D = 2, 16, 8
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)),
                               dtype=torch.float32) for h in (H, KH, KH))
    want = tattn.flash_attention(q, k, v, q_block=8, kv_block=8)
    want_d = tattn._decode_core(q[:, :1], k, v, S // 2, torch.float32)
    blocks = [tattn._head_block(H, m, r) for r in range(m)]
    assert [lo for lo, _ in blocks] == list(np.cumsum(
        [0] + [n for _, n in blocks[:-1]]))
    assert max(n for _, n in blocks) == -(-H // m)
    parts, parts_d = [], []
    for lo, Hl in blocks:
        kk, vv = tattn._my_kv(k, v, cfg, lo, Hl)
        assert torch.equal(kk[:, :, 0], k[:, :, lo * KH // H])
        mine = q[:, :, lo:lo + Hl]
        parts.append(tattn.flash_attention(mine, kk, vv, q_block=8,
                                           kv_block=8))
        parts_d.append(tattn._decode_core(mine[:, :1], kk, vv, S // 2,
                                          torch.float32))
    np.testing.assert_allclose(npf(torch.cat(parts, dim=2)), npf(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(npf(torch.cat(parts_d, dim=2)), npf(want_d),
                               rtol=1e-6, atol=1e-6)


# -------------------------------- MoE --------------------------------

def moe_cfg(k, d=32, f=64, E=4):
    return dataclasses.replace(f32("dbrx-132b"), moe_experts=E, moe_top_k=k,
                               d_model=d, d_ff=f)


@pytest.mark.parametrize("k,cf,groups", [(1, 0.5, 0), (2, 0.75, 0),
                                         (2, 4.0, 0), (1, 0.5, 4),
                                         (2, 0.75, 2)])
def test_moe_ffn_vs_reference(k, cf, groups):
    """Outputs within 1e-6; the kept assignments are identical: with
    capacity drops in the mix a different keep mask would move whole
    rows, and for top-1 the dropped rows are exactly the zero rows."""
    cfg = moe_cfg(k)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(k), cfg, jnp.float32)
    tp = to_t(rp)
    x = np.random.default_rng(7).normal(0, 1, size=(64, 32)).astype(
        np.float32)
    with roptions(moe_groups=groups), toptions(moe_groups=groups):
        want = npf(rmoe.moe_ffn(rp, jnp.asarray(x), cfg, capacity_factor=cf))
        got = npf(tmoe.moe_ffn(tp, torch.as_tensor(x), cfg,
                               capacity_factor=cf))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    zero_g, zero_w = ~got.any(axis=1), ~want.any(axis=1)
    np.testing.assert_array_equal(zero_g, zero_w)
    if cf < 1:
        assert zero_w.any() or k > 1          # capacity really drops


def test_moe_grouped_equals_dispatch_per_group():
    """G groups of T/G tokens route independently: the grouped path
    equals the plain dispatch run on each group alone."""
    cfg = moe_cfg(2)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(9), cfg, jnp.float32)
    tp = to_t(rp)
    x = torch.as_tensor(np.random.default_rng(8).normal(
        size=(48, 32)).astype(np.float32))
    with toptions(moe_groups=3):
        got = tmoe.moe_ffn(tp, x, cfg, capacity_factor=0.75)
    want = torch.cat([tmoe.moe_ffn(tp, xg, cfg, capacity_factor=0.75)
                      for xg in x.split(16)])
    np.testing.assert_allclose(npf(got), npf(want), rtol=1e-6, atol=1e-6)


def test_top_k_breaks_ties_like_jax():
    """Tied router logits: the port puts the lower expert first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order on ties)."""
    logits = np.array([[1.0, 3.0, 3.0, 3.0, 0.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 1.0, 0.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = tmoe._top_k(torch.as_tensor(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    _, ti = tmoe._top_k(torch.as_tensor(logits), 2)
    assert ti.tolist() == [[1, 2], [0, 1], [1, 3]]


def test_moe_tied_router_vs_reference():
    """Every token routes to tied experts (two equal router columns);
    the port keeps and drops the same assignments as the reference."""
    cfg = moe_cfg(1, d=16, f=32)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
    router = np.array(rp["router"])
    router[:, 2] = router[:, 1]
    rp = dict(rp, router=jnp.asarray(router))
    x = np.random.default_rng(2).normal(size=(16, 16)).astype(np.float32)
    want = npf(rmoe.moe_ffn(rp, jnp.asarray(x), cfg, capacity_factor=1.0))
    got = npf(tmoe.moe_ffn(to_t(rp), torch.as_tensor(x), cfg,
                           capacity_factor=1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(~got.any(axis=1), ~want.any(axis=1))


def test_moe_matches_dense_reference():
    """Mirror of tests/test_moe_ssm.py: with capacity >= all assignments,
    sort-based dispatch equals the explicit per-token expert mixture."""
    cfg = moe_cfg(2)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = to_t(rp)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, size=(24, 32)), dtype=torch.float32)
    got = tmoe.moe_ffn(p, x, cfg, capacity_factor=4.0)   # no drops
    logits = x @ p["router"]
    topi = torch.argsort(-logits, dim=-1)[:, :2]
    gates = torch.softmax(torch.gather(logits, 1, topi), dim=-1)
    ref = torch.zeros((24, 32))
    for tok in range(24):
        for jj in range(2):
            e = int(topi[tok, jj])
            h = x[tok] @ p["w_gate"][e]
            u = x[tok] @ p["w_up"][e]
            ref[tok] += gates[tok, jj] * ((torch.nn.functional.silu(h) * u)
                                          @ p["w_down"][e])
    np.testing.assert_allclose(npf(got), npf(ref), rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_tokens():
    """Mirror of tests/test_moe_ssm.py: identical tokens, capacity 1."""
    cfg = moe_cfg(1, d=16, f=32)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
    x = torch.ones((16, 16))
    out = tmoe.moe_ffn(to_t(rp), x, cfg, capacity_factor=0.25)
    assert int((out.abs().sum(dim=1) > 1e-9).sum()) <= 2


def test_aux_load_balance_loss_vs_reference():
    cfg = moe_cfg(2)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32)
    x = np.random.default_rng(4).normal(size=(40, 32)).astype(np.float32)
    want = float(rmoe.aux_load_balance_loss(rp, jnp.asarray(x), cfg))
    got = float(tmoe.aux_load_balance_loss(to_t(rp), torch.as_tensor(x),
                                           cfg))
    assert abs(got - want) <= 1e-6


# -------------------------------- SSD --------------------------------

@pytest.fixture(scope="module")
def ssm_case():
    cfg = f32("mamba2-130m")
    rp, _ = rssm.init_ssm(jax.random.PRNGKey(0), cfg, jnp.float32)
    # non-trivial A, D and dt so the decays and skips are exercised
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    rng = np.random.default_rng(3)
    rp = dict(rp, A_log=jnp.asarray(rng.normal(0, 0.5, H), jnp.float32),
              D=jnp.asarray(rng.normal(1, 0.3, H), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(0, 0.5, H), jnp.float32))
    x = np.random.default_rng(0).normal(0, 0.5, size=(2, 32, cfg.d_model))
    return cfg, rp, to_t(rp), x.astype(np.float32)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_forward_vs_reference(ssm_case, chunk):
    cfg, rp, tp, x = ssm_case
    want = rssm.ssd_forward(rp, jnp.asarray(x), cfg, chunk=chunk)
    got = tssm.ssd_forward(tp, torch.as_tensor(x), cfg, chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(npf(g), npf(w), rtol=1e-5, atol=1e-5)


def test_ssd_decode_vs_reference(ssm_case):
    cfg, rp, tp, x = ssm_case
    B = x.shape[0]
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    ch = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_groups * cfg.ssm_state
    rs = jnp.zeros((B, H, cfg.ssm_state, cfg.ssm_headdim), jnp.float32)
    rc = jnp.zeros((B, cfg.ssm_conv - 1, ch), jnp.float32)
    ts, tc = torch.tensor(np.asarray(rs)), torch.tensor(np.asarray(rc))
    for s in range(8):
        xt = x[:, s:s + 1]
        ry, rs, rc = rssm.ssd_decode(rp, jnp.asarray(xt), rs, rc, cfg)
        ty, ts, tc = tssm.ssd_decode(tp, torch.as_tensor(xt), ts, tc, cfg)
        for g, w in ((ty, ry), (ts, rs), (tc, rc)):
            np.testing.assert_allclose(npf(g), npf(w), rtol=1e-5, atol=1e-5)


def test_ssd_chunked_matches_sequential(ssm_case):
    """Mirror of tests/test_moe_ssm.py: the chunked forward equals the
    per-token recurrence, outputs and final state."""
    cfg, _, p, x = ssm_case
    x = torch.as_tensor(x[:, :16])
    y_chunk, st_chunk, tail = tssm.ssd_forward(p, x, cfg, chunk=8)
    B = x.shape[0]
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    ch = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_groups * cfg.ssm_state
    state = torch.zeros((B, H, cfg.ssm_state, cfg.ssm_headdim))
    conv = torch.zeros((B, cfg.ssm_conv - 1, ch))
    outs = []
    for s in range(x.shape[1]):
        y, state, conv = tssm.ssd_decode(p, x[:, s:s + 1], state, conv, cfg)
        outs.append(y)
    y_seq = torch.cat(outs, dim=1)
    np.testing.assert_allclose(npf(y_chunk), npf(y_seq), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(npf(st_chunk), npf(state), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(npf(tail), npf(conv), rtol=1e-6, atol=1e-6)


# ------------------------ the blocks without a mesh ------------------------

def _reference_keep(p, x, cfg, cf):
    """Which assignments the reference keeps: the routing lines of
    ``repro.models.moe._moe_dispatch`` (which does not return them)."""
    T = x.shape[0]
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = max(int(T * k * cf / E), 1)
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32), p["router"])
    _, topi = jax.lax.top_k(logits, k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    first = jnp.searchsorted(flat_e[order], jnp.arange(E))
    rank = jnp.zeros(T * k, jnp.int32).at[order].set(
        (jnp.arange(T * k) - first[flat_e[order]]).astype(jnp.int32))
    return np.asarray(rank < C)


def _converted(name):
    """The reference's float32 params of a smoke arch, and the port's
    carried over by ``params_from_reference``."""
    cfg = f32(name)
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), cfg,
        device="cpu")
    return cfg, rp, tp


def _layer0(rp, tp, *path):
    for k in path:
        rp, tp = rp[k], tp[k]
    return (jax.tree.map(lambda a: a[0], rp),
            {k: v[0] for k, v in tp.items()})


def test_blocks_without_a_mesh_vs_reference_on_converted_params(
        monkeypatch):
    """``moe_ffn``, ``ssd_forward``, ``ssd_decode`` and ``attn_decode``
    with no mesh, on layer 0 of the reference's params of the smoke
    dbrx-132b, mamba2-130m and qwen1.5-0.5b (float32) carried over by
    ``models.convert``: each within 1e-4 of the JAX function, and the
    MoE keep masks the reference's exactly, with drops and without.
    The sharded paths of these blocks must leave this one as it was."""
    rng = np.random.default_rng(21)
    tol = dict(rtol=1e-4, atol=1e-4)

    cfg, rp, tp = _converted("dbrx-132b")
    rffn, tffn = _layer0(rp, tp, "blocks", "ffn")
    x = rng.normal(size=(64, cfg.d_model)).astype(np.float32)
    keeps = []
    assign = tmoe._assign

    def recording(*a):
        out = assign(*a)
        keeps.append(out[2].numpy())
        return out
    monkeypatch.setattr(tmoe, "_assign", recording)
    for cf in (0.5, 1.25, 4.0):
        want = rmoe.moe_ffn(rffn, jnp.asarray(x), cfg, capacity_factor=cf)
        got = tmoe.moe_ffn(tffn, torch.as_tensor(x), cfg, capacity_factor=cf)
        np.testing.assert_allclose(npf(got), npf(want), **tol)
        ref_keep = _reference_keep(rffn, jnp.asarray(x), cfg, cf)
        np.testing.assert_array_equal(keeps.pop(), ref_keep)
        assert ref_keep.all() != (cf < 1)     # a capacity under 1 drops

    cfg, rp, tp = _converted("mamba2-130m")
    rssm_p, tssm_p = _layer0(rp, tp, "blocks", "ssm")
    x = rng.normal(0, 0.5, size=(2, 32, cfg.d_model)).astype(np.float32)
    want = rssm.ssd_forward(rssm_p, jnp.asarray(x), cfg, chunk=8)
    got = tssm.ssd_forward(tssm_p, torch.as_tensor(x), cfg, chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(npf(g), npf(w), **tol)
    rs, rc = want[1], want[2]
    ts, tc = got[1], got[2]
    for s in range(4):
        xt = x[:, s:s + 1]
        ry, rs, rc = rssm.ssd_decode(rssm_p, jnp.asarray(xt), rs, rc, cfg)
        ty, ts, tc = tssm.ssd_decode(tssm_p, torch.as_tensor(xt), ts, tc,
                                     cfg)
        for g, w in ((ty, ry), (ts, rs), (tc, rc)):
            np.testing.assert_allclose(npf(g), npf(w), **tol)

    cfg, rp, tp = _converted("qwen1.5-0.5b")
    rattn_p, tattn_p = _layer0(rp, tp, "blocks", "attn")
    B, Smax = 2, 8
    c0 = rng.normal(size=(B, Smax, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    rck, rcv = jnp.asarray(c0), jnp.asarray(-c0)
    tck, tcv = torch.tensor(c0), torch.tensor(-c0)
    for p in range(Smax):
        xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        ro, rck, rcv = rattn.attn_decode(rattn_p, jnp.asarray(xt), rck, rcv,
                                         jnp.int32(p), cfg)
        to, tck, tcv = tattn.attn_decode(tattn_p, torch.as_tensor(xt), tck,
                                         tcv, p, cfg)
        for g, w in ((to, ro), (tck, rck), (tcv, rcv)):
            np.testing.assert_allclose(npf(g), npf(w), **tol)
