"""BSW of the port: the plain PyTorch lockstep batch (the bsw kernel's
plain version, ``kernels.bsw.ref``) against the reference's Pallas
kernel (interpret mode) and its scalar ksw_extend2 oracle.  Scores and
coordinates are integers, so equality is exact."""

import numpy as np
import pytest
import torch

from repro.core.bsw import BSWParams as RParams, bsw_extend as r_extend
from repro.kernels.bsw import bsw_extend_pallas
from repro_torch.core.bsw import (BSWParams, ExtResult, adjusted_band,
                                  bsw_extend, bsw_extend_tasks, pack_tasks)
from repro_torch.kernels.bsw import bsw_call, bsw_extend_kernel
from repro_torch.kernels.bsw.ref import bsw_ref

torch.set_num_threads(1)


def tasks(seed, n, qmax, tmax, *, related=True, amb=False):
    rng = np.random.default_rng(seed)
    qs, ts, h0s = [], [], []
    hi = 5 if amb else 4
    for _ in range(n):
        ql = int(rng.integers(1, qmax + 1))
        tl = int(rng.integers(1, tmax + 1))
        q = rng.integers(0, hi, ql).astype(np.uint8)
        t = rng.integers(0, hi, tl).astype(np.uint8)
        if related:                   # share a prefix so scores stay high
            m = min(ql, tl, int(rng.integers(0, 40)))
            t[:m] = q[:m]
        qs.append(q)
        ts.append(t)
        h0s.append(int(rng.integers(1, 50)))
    return qs, ts, h0s


def as_tuples(res):
    return [(r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off) for r in res]


@pytest.mark.parametrize("seed,n,qmax,tmax,w", [
    (0, 12, 30, 36, None),
    (1, 9, 64, 20, None),
    (2, 7, 16, 64, 7),
    (3, 10, 40, 40, 1),
])
def test_plain_equals_pallas_and_scalar(seed, n, qmax, tmax, w):
    p = BSWParams()
    qs, ts, h0s = tasks(seed, n, qmax, tmax, amb=seed % 2 == 1)
    ws = None if w is None else [w] * n
    got = bsw_extend_kernel(qs, ts, h0s, p, ws=ws, device="cpu")
    want = bsw_extend_pallas(qs, ts, h0s, RParams(), ws=ws)
    assert as_tuples(got) == as_tuples(want)
    for q, t, h0, g in zip(qs, ts, h0s, got):
        ww = p.w if w is None else w
        assert g == bsw_extend(q, t, h0, p, ww)
        assert as_tuples([g]) == as_tuples([r_extend(q, t, h0, RParams(), ww)])


def test_band_width_one():
    p = BSWParams()
    assert adjusted_band(30, p, 1) == 1
    qs, ts, h0s = tasks(42, 12, 40, 48, related=False)
    got = bsw_extend_kernel(qs, ts, h0s, p, ws=[1] * 12, device="cpu")
    assert got == [bsw_extend(q, t, h0, p, 1)
                   for q, t, h0 in zip(qs, ts, h0s)]


def test_zdrop_triggers_and_matches():
    """A 40-bp exact match, a 20-bp unrelated gap, then a 100-bp exact
    match: z-drop stops the extension in the gap, so it never sees the
    higher score past it (which it finds with z-drop off)."""
    rng = np.random.default_rng(7)
    p = BSWParams(zdrop=20)
    qs, ts = [], []
    for _ in range(6):
        head, tail = rng.integers(0, 4, 40), rng.integers(0, 4, 100)
        qs.append(np.concatenate([head, rng.integers(0, 4, 20), tail]
                                 ).astype(np.uint8))
        ts.append(np.concatenate([head, rng.integers(0, 4, 20), tail]
                                 ).astype(np.uint8))
    h0s = [30] * 6
    got = bsw_extend_kernel(qs, ts, h0s, p, device="cpu")
    assert got == [bsw_extend(q, t, 30, p) for q, t in zip(qs, ts)]
    no_zdrop = bsw_extend_kernel(qs, ts, h0s, BSWParams(zdrop=0),
                                 device="cpu")
    assert all(a.score < b.score for a, b in zip(got, no_zdrop))
    assert as_tuples(got) == as_tuples(bsw_extend_pallas(
        qs, ts, h0s, RParams(zdrop=20)))


def test_padded_block_shape_hints():
    """qmax/tmax hints larger than the tasks (bsw_extend_tasks pads to
    multiples of 32) do not change results."""
    p = BSWParams()
    qs, ts, h0s = tasks(5, 8, 20, 25)
    a = bsw_extend_kernel(qs, ts, h0s, p, device="cpu")
    b = bsw_extend_kernel(qs, ts, h0s, p, qmax=64, tmax=96, device="cpu")
    assert a == b


def test_tasks_driver_sorts_and_short_circuits():
    p = BSWParams()
    qs, ts, h0s = tasks(9, 20, 30, 30)
    qs[3] = np.zeros(0, np.uint8)                  # empty query: no-op result
    fn = lambda *a, **k: bsw_extend_kernel(*a, **k, device="cpu")
    res, st = bsw_extend_tasks(qs, ts, h0s, p, batch_fn=fn, block=8)
    assert res[3] == ExtResult(h0s[3], 0, 0, 0, -1, 0)
    for j in range(20):
        if j != 3:
            assert res[j] == bsw_extend(qs[j], ts[j], h0s[j], p)
    assert st["tasks"] == 19


def test_pack_tasks_layout():
    p = BSWParams()
    qs, ts, h0s = tasks(3, 4, 10, 12)
    q, t, ql, tl, h0, ws = pack_tasks(qs, ts, h0s, p, [1, 5, 100, 300],
                                      qmax=16, tmax=16)
    assert q.shape == (4, 16) and t.shape == (4, 16) and q.dtype == np.int32
    assert (q[0, len(qs[0]):] == 4).all()
    assert ws.tolist() == [adjusted_band(len(x), p, w)
                           for x, w in zip(qs, [1, 5, 100, 300])]
    out = bsw_call(*(torch.from_numpy(a) for a in (q, t, ql, tl, h0, ws)), p)
    assert out.shape == (6, 4) and out.dtype == torch.int32
    assert torch.equal(out, bsw_ref(*(torch.from_numpy(a) for a in
                                      (q, t, ql, tl, h0, ws)), p))
