"""The port's serving path: the step factories and ``serve_batch``
against the JAX package, the CLI, and the port's mirrors of the
reference's decode-against-forward and unrolled-against-scanned tests.

``repro.launch.serve.serve_batch`` fails on its second step: it takes
the argmax of the (B, 1, V) logits and appends an axis, so the next
tokens are (B, 1, 1), and ``jnp.where`` broadcasts them with the (B, 1)
prompt tokens to (B, B, 1).  The port takes the argmax over the last
position's (B, V) logits.  ``test_reference_serve_batch_fault`` pins the
fault; the port is held against the reference's loop with that one line
changed (``reference_serve``), stepping the reference's own jitted
``lm.decode_step``.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import lm as rlm
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def f32(name):
    return dataclasses.replace(smoke_config(name), dtype="float32")


def carried(cfg, seed=0):
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), cfg,
        device="cpu")
    return rp, tp


def prompts_of(cfg, n, seed=0):
    """The prompts of ``repro.launch.serve.main``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=rng.integers(4, 40))
            .astype(np.int32) for _ in range(n)]


def reference_serve(cfg, params, prompts, max_new, *, sort_by_length=True):
    """``repro.launch.serve.serve_batch`` with its shape fault fixed (the
    argmax over the last position), on the reference's jitted
    ``lm.decode_step``; returns (outputs, stats, per-step logits)."""
    B = len(prompts)
    lens = np.array([len(p) for p in prompts])
    order = np.argsort(lens) if sort_by_length else np.arange(B)
    inv = np.argsort(order)
    lens_s = lens[order]
    cache = rlm.init_cache(cfg, B, int(lens.max()) + max_new)
    toks = np.zeros((B, int(lens.max())), np.int32)
    for i, o in enumerate(order):
        toks[i, :lens_s[i]] = prompts[o]
    decode = jax.jit(lambda p, c, t, pos: rlm.decode_step(p, cfg, c, t, pos))
    out_tokens = [[] for _ in range(B)]
    cur = jnp.asarray(toks[:, :1])
    logits_seen = []
    for pos in range(int(lens.max()) + max_new - 1):
        logits, cache = decode(params, cache, {"tokens": cur}, jnp.int32(pos))
        logits_seen.append(np.asarray(logits[:, -1], np.float32))
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        if pos + 1 < toks.shape[1]:
            forced = jnp.asarray(toks[:, pos + 1:pos + 2])
            use_forced = (pos + 1 < lens_s)[:, None]
            cur = jnp.where(jnp.asarray(use_forced), forced, nxt)
        else:
            cur = nxt
        for i in range(B):
            if pos + 1 >= lens_s[i]:
                out_tokens[i].append(int(cur[i, 0]))
    outs = [np.array(out_tokens[inv[i]][:max_new], np.int32)
            for i in range(B)]
    stats = {"useful_prefill_tokens": int(lens.sum()),
             "padded_tokens": B * int(lens.max()),
             "lane_efficiency": int(lens.sum()) / (B * int(lens.max()))}
    return outs, stats, logits_seen


def test_reference_serve_batch_fault():
    cfg = f32("qwen1.5-0.5b")
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="too many values to unpack"):
        rserve.serve_batch(cfg, rp, prompts_of(cfg, 2), 2)


@pytest.mark.parametrize("sort_by_length", [True, False])
def test_serve_batch_equals_reference(sort_by_length):
    """Smoke Qwen1.5-0.5B in float32 on carried-across params: the same
    tokens and the same stats, exactly; each step's logits within
    1e-4."""
    cfg = f32("qwen1.5-0.5b")
    rp, tp = carried(cfg)
    prompts = prompts_of(cfg, 8)
    want, want_stats, want_logits = reference_serve(
        cfg, rp, prompts, 16, sort_by_length=sort_by_length)
    seen = []
    got, stats = tserve.serve_batch(
        cfg, tp, prompts, 16, sort_by_length=sort_by_length,
        on_step=lambda pos, lg: seen.append((pos, lg.float().numpy())))
    assert stats == want_stats
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (16,)
        np.testing.assert_array_equal(g, w)
    assert [p for p, _ in seen] == list(range(len(want_logits)))
    for (_, g), w in zip(seen, want_logits):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_serve_batch_native_bf16_and_short_outputs():
    """bf16 smoke Qwen: every output has max_new ids in [0, vocab), and a
    second run gives the same tokens."""
    cfg = smoke_config("qwen1.5-0.5b")
    params, _ = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(3),
                                device="cpu")
    prompts = prompts_of(cfg, 5, seed=4)
    a, st = tserve.serve_batch(cfg, params, prompts, 6)
    b, _ = tserve.serve_batch(cfg, params, prompts, 6)
    for x, y in zip(a, b):
        assert x.shape == (6,) and ((0 <= x) & (x < cfg.vocab)).all()
        np.testing.assert_array_equal(x, y)
    lens = [len(p) for p in prompts]
    assert st["padded_tokens"] == 5 * max(lens)
    assert st["useful_prefill_tokens"] == sum(lens)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "musicgen-large",
                                  "zamba2-7b"])
def test_prefill_and_decode_steps_equal_reference(name):
    cfg = f32(name)
    rp, tp = carried(cfg, seed=5)
    rng = np.random.default_rng(5)
    shape = (2, 16, cfg.n_codebooks) if cfg.n_codebooks else (2, 16)
    toks = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    rpre = rsteps.make_prefill_step(cfg, q_block=8, kv_block=8)
    tpre = tsteps.make_prefill_step(cfg, q_block=8, kv_block=8)
    want = np.asarray(rpre(rp, {"tokens": jnp.asarray(toks)}))
    with torch.inference_mode():
        got = tpre(tp, {"tokens": torch.tensor(toks)}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    rdec = jax.jit(rsteps.make_decode_step(cfg))
    tdec = tsteps.make_decode_step(cfg)
    rc = rlm.init_cache(cfg, 2, 16)
    tc = tlm.init_cache(cfg, 2, 16, device="cpu")
    with torch.inference_mode():
        for pos in range(16):
            rl, rc = rdec(rp, rc, {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                          jnp.int32(pos))
            tl, tc = tdec(tp, tc, {"tokens": torch.tensor(
                toks[:, pos:pos + 1])}, pos)
            assert tl.shape == rl.shape
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                       rtol=1e-4, atol=1e-4)
    # the last decode step's logits are the prefill step's
    np.testing.assert_allclose(tl.numpy(), got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "internlm2-1.8b",
                                  "mamba2-130m", "zamba2-7b",
                                  "musicgen-large"])
def test_decode_matches_forward(name):
    """Mirror of tests/test_models.py::test_decode_matches_forward on the
    port: teacher-forced decode reproduces the full forward logits at
    every position (cache correctness across all families), bf16."""
    cfg = smoke_config(name)
    rng = np.random.default_rng(1)
    params, _ = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(1),
                                device="cpu")
    S = 16
    shape = (2, S, cfg.n_codebooks) if cfg.n_codebooks else (2, S)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=shape))
    with torch.inference_mode():
        full = tlm.forward(params, cfg, {"tokens": toks}, q_block=8,
                           kv_block=8).float().numpy()
        cache = tlm.init_cache(cfg, 2, S, device="cpu")
        outs = []
        for pos in range(S):
            lg, cache = tlm.decode_step(params, cfg, cache,
                                        {"tokens": toks[:, pos:pos + 1]}, pos)
            outs.append(lg.float().numpy()[:, 0])
    dec = np.stack(outs, axis=1)
    np.testing.assert_allclose(dec, full, rtol=3e-2, atol=3e-2)
    assert (dec.argmax(-1) == full.argmax(-1)).mean() > 0.9


def test_unrolled_matches_scanned():
    """Mirror of tests/test_models.py::test_unrolled_matches_scanned: both
    values of scan_layers run the same layer loop, so equal exactly."""
    cfg = smoke_config("internlm2-1.8b")
    params, _ = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(2),
                                device="cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 16)))
    with torch.inference_mode():
        a = tlm.forward(params, cfg, {"tokens": toks}, q_block=8, kv_block=8)
        cfg2 = dataclasses.replace(cfg, scan_layers=False)
        b = tlm.forward(params, cfg2, {"tokens": toks}, q_block=8,
                        kv_block=8)
    assert torch.equal(a, b)


def test_serve_cli_smoke_on_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu``: exit
    0, the lane efficiency of the reference's prompts, and the first
    output of ``serve_batch`` on the same seeded params."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.strip().splitlines()
    cfg = smoke_config("qwen1.5-0.5b")
    prompts = prompts_of(cfg, 8)
    lens = np.array([len(p) for p in prompts])
    eff = lens.sum() / (8 * lens.max())
    m = re.fullmatch(r"served 8 requests in [0-9.]+s; lane efficiency "
                     r"([0-9.]+)", first)
    assert m and m.group(1) == f"{eff:.2f}"
    params, _ = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                                device="cpu")
    outs, _ = tserve.serve_batch(cfg, params, prompts, 16)
    assert second == f"first output: {outs[0][:10]}"
