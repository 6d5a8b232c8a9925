"""Port of the FM-index (repro_torch.core.fmindex): host build, the index
carried across from the JAX package, and the plain occ / extension
functions against the reference's jnp, numpy and Pallas (interpret)
versions.  Every value is an integer, so equality is exact."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fmindex as rfm
from repro.kernels.fmocc import make_occ_fn as pallas_occ_fn
from repro_torch.core import contig as tcontig
from repro_torch.core import fmindex as tfm
from repro_torch.core import smem as tsm
from repro_torch.data import make_reference
from repro_torch.kernels.engine import sweep_occ_configs
from repro_torch.kernels.fmocc import DEFAULT_CANDIDATE, OccConfig, occ

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    ref = make_reference(12000, seed=7)
    return rfm.build_index(ref), tfm.build_index(ref)


def edge_queries(N: int, primary: int) -> np.ndarray:
    """i = -1, 0, N-2, N-1, bucket edges +-1 of both layouts (at the
    start and around ``primary``) and primary +-1."""
    edge = {-1, 0, 30, 31, 32, 33, 126, 127, 128, 129, 255, 256,
            N - 130, N - 2, N - 1, primary - 1, primary, primary + 1}
    for eta in (32, 128):
        b = primary // eta
        edge.update((b * eta - 2, b * eta - 1, b * eta, (b + 1) * eta - 1,
                     (b + 1) * eta))
    return np.array(sorted(i for i in edge if -1 <= i <= N - 1), np.int32)


def cq(N, primary):
    ii = edge_queries(N, primary)
    return (np.tile(np.arange(4, dtype=np.int32), len(ii)),
            np.repeat(ii, 4))


def test_build_index_arrays_equal(pair):
    ridx, tidx = pair
    for k in tfm.PERSIST_ARRAYS:
        a, b = getattr(ridx, k), getattr(tidx, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in tfm.PERSIST_SCALARS:
        assert getattr(ridx, k) == getattr(tidx, k)


def test_index_from_reference(pair):
    ridx, _ = pair
    got = tcontig.index_from_reference(
        {k: getattr(ridx, k) for k in rfm.PERSIST_ARRAYS},
        {k: getattr(ridx, k) for k in rfm.PERSIST_SCALARS})
    for k in tfm.PERSIST_ARRAYS:
        assert np.array_equal(getattr(got, k), getattr(ridx, k)), k
    fm_r, fm_t = ridx.device(), got.device(CPU)
    c, i = cq(int(ridx.N), int(ridx.primary))
    want = np.asarray(rfm.occ_opt_v(fm_r, jnp.asarray(c), jnp.asarray(i)))
    have = tfm.occ_opt_v(fm_t, torch.from_numpy(c), torch.from_numpy(i))
    assert np.array_equal(have.numpy(), want)
    rows = torch.arange(0, int(ridx.N), 97)
    assert np.array_equal(fm_t.sa[rows].numpy(),
                          np.asarray(fm_r.sa)[rows.numpy()])
    with pytest.raises(ValueError, match="missing"):
        tcontig.index_from_reference({}, {})


def test_device_view_cached_and_typed(pair):
    _, tidx = pair
    fm = tidx.device("cpu")
    assert tidx.device(CPU) is fm
    assert fm.occ32_bytes.dtype == torch.uint8
    assert fm.sa.dtype == torch.int32 and fm.sa.device == CPU
    assert fm.nbytes() > 0


@pytest.mark.parametrize("layout", ["eta32", "eta128"])
def test_occ_plain_equals_reference_at_edges(pair, layout):
    ridx, tidx = pair
    N, prim = int(tidx.N), int(tidx.primary)
    c, i = cq(N, prim)
    fm_r, fm_t = ridx.device(), tidx.device(CPU)
    ref_v = rfm.occ_opt_v if layout == "eta32" else rfm.occ_base_v
    want = np.asarray(ref_v(fm_r, jnp.asarray(c), jnp.asarray(i)))
    want_np = (rfm.occ_opt_np if layout == "eta32" else rfm.occ_base_np)(
        ridx, c.astype(np.int64), i.astype(np.int64))
    want_pallas = np.asarray(pallas_occ_fn(layout, 256)(
        fm_r, jnp.asarray(c), jnp.asarray(i)))
    plain = (tfm.occ_opt_v if layout == "eta32" else tfm.occ_base_v)(
        fm_t, torch.from_numpy(c), torch.from_numpy(i))
    wrapped = occ(fm_t, torch.from_numpy(c), torch.from_numpy(i),
                  layout=layout)
    for got in (plain, wrapped):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, want_np) and np.array_equal(want, want_pallas)
    # i = N-1 counts the whole BWT: every row but the sentinel
    full = occ(fm_t, torch.arange(4, dtype=torch.int32),
               torch.full((4,), N - 1, dtype=torch.int32), layout=layout)
    assert int(full.sum()) == N - 1


@pytest.mark.parametrize("layout", ["eta32", "eta128"])
@pytest.mark.parametrize("which", ["bwd", "fwd"])
def test_extension_equals_reference(pair, layout, which):
    ridx, tidx = pair
    rng = np.random.default_rng(11)
    N = int(tidx.N)
    k = rng.integers(0, N, 300).astype(np.int32)
    s = np.minimum(rng.integers(0, 40, 300), N - k).astype(np.int32)
    s[:10] = 0
    l = rng.integers(0, N, 300).astype(np.int32)
    c = rng.integers(0, 6, 300).astype(np.int32)      # 4, 5: invalid bases
    ref_fn = rfm.backward_ext_v if which == "bwd" else rfm.forward_ext_v
    occ_r = rfm.occ_opt_v if layout == "eta32" else rfm.occ_base_v
    want = ref_fn(ridx.device(), *(jnp.asarray(a) for a in (k, l, s, c)),
                  occ_fn=occ_r)
    want_np = (rfm.backward_ext_np if which == "bwd" else rfm.forward_ext_np)(
        ridx, k, l, s, c)
    fn = tfm.backward_ext_v if which == "bwd" else tfm.forward_ext_v
    got = fn(tidx.device(CPU), *(torch.from_numpy(a) for a in (k, l, s, c)),
             occ_fn=functools.partial(occ, layout=layout))
    for g, w, wn in zip(got, want, want_np):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), wn)


def test_occ_fn_carries_device_and_is_stable(pair):
    # the configuration SMEM's rounds read: a frozen value, the default
    # the one the sweep gives where there is no kernel to time
    f = OccConfig("eta128", 512, "cpu")
    assert f == OccConfig("eta128", 512, "cpu") and hash(f) == hash(
        OccConfig("eta128", 512, "cpu"))
    assert (f.layout, f.block, f.device) == ("eta128", 512, "cpu")
    assert sweep_occ_configs(None, CPU) == OccConfig(*DEFAULT_CANDIDATE,
                                                     "cpu")
    with pytest.raises(ValueError, match="unknown occ layout"):
        tsm._ext_round(pair[1], "bwd", np.zeros((4, 1), np.int32),
                       OccConfig("eta64", 256, "cpu"))
    with pytest.raises(ValueError, match="unknown occ layout"):
        occ(None, torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), layout="eta64")
