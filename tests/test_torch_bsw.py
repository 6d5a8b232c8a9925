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


def kernel_results(*a, **k) -> list[ExtResult]:
    """``bsw_extend_kernel``'s (6, W) rows, one ExtResult a task."""
    return [ExtResult(*r) for r in bsw_extend_kernel(*a, **k).T.tolist()]


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
    got = kernel_results(qs, ts, h0s, p, ws=ws, device="cpu")
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
    got = kernel_results(qs, ts, h0s, p, ws=[1] * 12, device="cpu")
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
    got = kernel_results(qs, ts, h0s, p, device="cpu")
    assert got == [bsw_extend(q, t, 30, p) for q, t in zip(qs, ts)]
    no_zdrop = kernel_results(qs, ts, h0s, BSWParams(zdrop=0),
                              device="cpu")
    assert all(a.score < b.score for a, b in zip(got, no_zdrop))
    assert as_tuples(got) == as_tuples(bsw_extend_pallas(
        qs, ts, h0s, RParams(zdrop=20)))


def test_padded_block_shape_hints():
    """qmax/tmax hints larger than the tasks (bsw_extend_tasks pads to
    multiples of 32) do not change results."""
    p = BSWParams()
    qs, ts, h0s = tasks(5, 8, 20, 25)
    a = kernel_results(qs, ts, h0s, p, device="cpu")
    b = kernel_results(qs, ts, h0s, p, qmax=64, tmax=96, device="cpu")
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


def _related(rng, qlens, tlens, hi=4):
    """Targets that copy their query with ~5% substitutions, so scores stay
    high and the band stays wide."""
    qs, ts = [], []
    for ql, tl in zip(qlens, tlens):
        q = rng.integers(0, hi, ql).astype(np.uint8)
        t = rng.integers(0, hi, tl).astype(np.uint8)
        k = min(ql, tl)
        t[:k] = np.where(rng.random(k) < 0.05, rng.integers(0, hi, k), q[:k])
        qs.append(q)
        ts.append(t)
    return qs, ts


def _hard_case(name):
    """The shapes the warp-per-task kernel finds hard: name -> (queries,
    targets, h0s, ws, BSWParams, also check the Pallas kernel)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "strip_edges":       # qlen on either side of 32 and 64
        ql = [31, 32, 33, 63, 64, 65]
        qs, ts = _related(rng, ql, [q + int(rng.integers(-5, 20)) for q in ql])
        return qs, ts, [int(v) for v in rng.integers(5, 60, 6)], None, \
            BSWParams(), True
    if name == "long_rows":         # qmax 256, tmax 300, a band as wide as
        ql, tl = [256, 250, 231, 200], [300, 290, 270, 256]  # the query:
        qs, ts = _related(rng, ql, tl)                       # 8 strips a row
        return qs, ts, [40, 1, 90, 25], [256] * 4, BSWParams(), False
    if name == "first_row_fill":    # h0 - oe_ins > 32 e_ins: the fill of
        ql = [40, 70, 100, 130]     # row 0 runs past the first strips
        qs, ts = _related(rng, ql, [q // 2 for q in ql])
        return qs, ts, [60, 100, 150, 200], None, BSWParams(), True
    if name == "band_one_long":     # w = 1 on a long query
        ql = [160, 200, 97, 130]
        qs, ts = _related(rng, ql, [q + 3 for q in ql])
        return qs, ts, [30, 5, 70, 12], [1] * 4, BSWParams(), False
    if name == "ambiguous":         # code 4 in queries and targets
        ql = [33, 40, 64, 65, 20, 90]
        qs, ts = _related(rng, ql, [q + 8 for q in ql], hi=5)
        return qs, ts, [int(v) for v in rng.integers(1, 80, 6)], None, \
            BSWParams(zdrop=50), True
    raise KeyError(name)


@pytest.mark.parametrize("name", ["strip_edges", "long_rows",
                                  "first_row_fill", "band_one_long",
                                  "ambiguous"])
def test_plain_on_kernel_hard_shapes(name):
    """The plain version on strip edges, long rows, a first-row fill across
    strips, a band of width 1 on a long query and ambiguous codes on both
    sides, against the reference's scalar oracle and (small shapes) its
    Pallas kernel in interpret mode."""
    qs, ts, h0s, ws, p, pallas = _hard_case(name)
    rp = RParams(zdrop=p.zdrop)
    if name == "first_row_fill":
        assert all(h - p.o_ins - p.e_ins > 32 * p.e_ins for h in h0s)
    if name == "ambiguous":
        assert all((q == 4).any() and (t == 4).any() for q, t in zip(qs, ts))
    got = kernel_results(qs, ts, h0s, p, ws=ws, device="cpu")
    wid = [p.w if ws is None else w for w in (ws or [None] * len(qs))]
    assert as_tuples(got) == as_tuples(
        [r_extend(q, t, h0, rp, w) for q, t, h0, w in zip(qs, ts, h0s, wid)])
    if pallas:
        assert as_tuples(got) == as_tuples(
            bsw_extend_pallas(qs, ts, h0s, rp, ws=ws))


@pytest.mark.parametrize("W,qmax,sms,want", [
    (256, 101, 132, (128, 2, 2 * 944)),     # a real block: 2 warps a CTA
    (844, 160, 132, (121, 7, 7 * 1488)),    # four real blocks in one launch
    (1, 1, 132, (1, 1, 48)),
    (100, 256, 132, (100, 1, 2352)),        # fewer tasks than SMs
    (5000, 64, 132, (625, 8, 8 * 624)),     # capped at MAX_WARPS
    (300, 15000, 132, (300, 1, 135040)),    # two tasks' rows do not fit
    (40, 128, 16, (14, 3, 3 * 1200)),       # another SM count
])
def test_launch_geometry(W, qmax, sms, want):
    from repro_torch.kernels.bsw.ops import (SMEM_LIMIT, launch_geometry,
                                             warp_smem_bytes)
    ctas, warps, smem = launch_geometry(W, qmax, sms)
    assert (ctas, warps, smem) == want
    per_warp = warp_smem_bytes(qmax)
    assert per_warp % 16 == 0 and per_warp >= 9 * (qmax + 1)
    assert smem == warps * per_warp <= SMEM_LIMIT
    assert ctas == -(-W // warps)


def test_launch_geometry_rejects_rows_too_long():
    """One task's H/E rows and query must fit in a CTA's shared memory;
    otherwise the wrapper raises, with no fallback."""
    from repro_torch.kernels.bsw.ops import SMEM_LIMIT, launch_geometry
    # 9 bytes a column (H, E, query) over qmax + 1 columns rounded up to 4
    qmax = SMEM_LIMIT // 36 * 4 - 1
    assert launch_geometry(1, qmax, 132) == (1, 1, 9 * (qmax + 1))
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(1, qmax + 1, 132)
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(256, 1 << 20, 132)
