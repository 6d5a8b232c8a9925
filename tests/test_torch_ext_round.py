"""The fused SMEM extension round of the port (``kernels.fmocc.ext_round``
and ``core.smem._ext_round``) against the reference: the plain round on
random and edge entries against the JAX package's jitted rounds with the
Pallas occ kernel (interpret mode on the CPU), the round of a compact
(4, n) host buffer against the plain round over the dense arrays it was
taken from, and the bytes a whole SMEM search sends.
Every value is an integer, so equality is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fmindex as rfm
from repro.core import smem as rsm
from repro.kernels.fmocc import backward_ext_pallas
from repro.kernels.fmocc import make_occ_fn as pallas_occ_fn
from repro_torch import obs
from repro_torch.core import fmindex as tfm
from repro_torch.core import smem as tsm
from repro_torch.data import make_reference, simulate_reads
from repro_torch.kernels.engine import sweep_entries
from repro_torch.kernels.fmocc import OccConfig, ext_round
from repro_torch.kernels.fmocc.ref import ext_round_ref

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    ref = make_reference(12000, seed=7)
    return rfm.build_index(ref), tfm.build_index(ref)


def edge_positions(N: int, primary: int) -> list[int]:
    """i = -1, 0, N-2, N-1, bucket edges +-1 of both layouts (at the
    start and around ``primary``) and primary +-1."""
    edge = {-1, 0, 30, 31, 32, 33, 126, 127, 128, 129, 255, 256,
            N - 130, N - 2, N - 1, primary - 1, primary, primary + 1}
    for eta in (32, 128):
        b = primary // eta
        edge.update((b * eta - 2, b * eta - 1, b * eta, (b + 1) * eta - 1,
                     (b + 1) * eta))
    return sorted(i for i in edge if -1 <= i <= N - 1)


def entries(N: int, primary: int, n: int = 300, seed: int = 11):
    """(k, l, s, c) int32: ``n`` random entries (s = 0 for the first 10,
    c in 0..5 with 4 and 5 ambiguous bases), then for every edge position
    i and every c in 0..4 the entries with k-1 = i (s = 0 and s = 3) and
    with k+s-1 = i.  l = k on the edge entries, and every [l, l+s) lies in
    [0, N], so both directions read inside the index."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, N, n)
    l = rng.integers(0, N, n)
    s = np.minimum(rng.integers(0, 40, n), N - np.maximum(k, l))
    s[:10] = 0
    c = rng.integers(0, 6, n)
    rows = [np.stack([k, l, s, c])]
    for i in edge_positions(N, primary):
        for kk, ss in ((i + 1, 0), (i + 1, min(3, N - i - 1)),
                       (i + 1 - min(5, i + 1), min(5, i + 1))):
            rows.append(np.array([[kk] * 5, [kk] * 5, [ss] * 5, range(5)]))
    return tuple(np.concatenate(rows, axis=1).astype(np.int32))


@pytest.mark.parametrize("layout, which", [
    ("eta32", "bwd"), ("eta32", "fwd"), ("eta128", "bwd"), ("eta128", "fwd")])
def test_ext_round_equals_reference_rounds(pair, layout, which):
    ridx, tidx = pair
    k, l, s, c = entries(int(tidx.N), int(tidx.primary))
    got = ext_round(tidx.device(CPU), which,
                    *(torch.from_numpy(a) for a in (k, l, s, c)),
                    layout=layout)
    assert got.dtype == torch.int32 and got.shape == (3, len(k))
    jround = rsm._bwd_round_j if which == "bwd" else rsm._fwd_round_j
    jargs = (ridx.device(), *(jnp.asarray(a) for a in (k, l, s, c)))
    want = jround(*jargs, occ_fn=pallas_occ_fn(layout))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if (layout, which) == ("eta32", "bwd"):
        for g, w in zip(got, backward_ext_pallas(*jargs)):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout, which", [
    ("eta32", "bwd"), ("eta32", "fwd"), ("eta128", "bwd"), ("eta128", "fwd")])
def test_compacted_round_equals_padded_round(pair, layout, which):
    _, tidx = pair
    N = int(tidx.N)
    rng = np.random.default_rng(3)
    T, P = 37, 102
    k = rng.integers(0, N, (T, P))
    l = rng.integers(0, N, (T, P))
    s = np.minimum(rng.integers(1, 30, (T, P)), N - np.maximum(k, l))
    c = rng.integers(0, 5, (T, 1))          # one base a task, as bwd rounds
    live = rng.random((T, P)) < 0.1
    live[0] = False                         # a task with no live entry
    plain = ext_round_ref(tidx.device(CPU), which,
                          *(torch.from_numpy(np.broadcast_to(a, (T, P))
                                             .astype(np.int32))
                            for a in (k, l, s, c)), layout=layout)
    # the live entries in row-major order, as the loop holds them
    host = np.stack([np.broadcast_to(a, (T, P))[live] for a in (k, l, s, c)]
                    ).astype(np.int32)
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        got = tsm._ext_round(tidx, which, host,
                             OccConfig(layout, 256, "cpu"))
    n = int(live.sum())
    assert got.dtype == np.int32 and got.shape == (3, n)
    for g, w in zip(got, plain.numpy()):
        assert np.array_equal(g, w[live])
    snap = reg.snapshot()
    assert (snap["smem_rounds"], snap["smem_h2d_bytes"],
            snap["smem_d2h_bytes"]) == (1, 16 * n, 12 * n)
    assert snap["smem_live_entries"] == snap["smem_round_slots"] == n


def test_round_without_live_entries_sends_nothing(pair):
    _, tidx = pair
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        got = tsm._ext_round(tidx, "fwd", np.zeros((4, 0), np.int32),
                             OccConfig("eta32", 256, "cpu"))
    assert got.shape == (3, 0)
    snap = reg.snapshot()
    assert snap["smem_rounds"] == 1
    assert snap.get("smem_h2d_bytes", 0) == snap.get("smem_d2h_bytes", 0) == 0


@pytest.fixture(scope="module")
def world():
    ref = make_reference(12000, seed=5)
    reads, _ = simulate_reads(ref, 12, 101, seed=2)
    reads = reads.copy()
    reads[0, 10:14] = 4            # a run of ambiguous bases
    reads[1, 0] = 4                # leading N
    reads[2, -1] = 4               # trailing N
    reads[3, ::17] = 4             # scattered Ns
    return rfm.build_index(ref), tfm.build_index(ref), reads


@pytest.mark.parametrize("layout", ["eta32", "eta128"])
def test_smem_sends_only_live_entries(world, layout, monkeypatch):
    ridx, tidx, reads = world
    lens = np.full(len(reads), reads.shape[1], np.int64)
    sent = []
    real = tsm._ext_round

    def counting(idx, which, host, occ):
        sent.append(host.shape[1])
        return real(idx, which, host, occ)
    monkeypatch.setattr(tsm, "_ext_round", counting)
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        got = tsm.collect_smems_batch(tidx, reads, lens, tsm.MemOptions(),
                                      occ=OccConfig(layout, 256, "cpu"))
    assert got == rsm.collect_smems_batch(ridx, reads, lens, rsm.MemOptions())
    snap = reg.snapshot()
    assert snap["smem_rounds"] == len(sent) and min(sent) > 0
    # the host state holds the live entries alone: every row it sends
    assert snap["smem_live_entries"] == snap["smem_round_slots"] == sum(sent)
    assert snap["smem_h2d_bytes"] == 16 * sum(sent)
    assert snap["smem_d2h_bytes"] * 4 == snap["smem_h2d_bytes"] * 3


def test_sweep_entries_stay_inside_the_index():
    N = 1000
    k, l, s, c = sweep_entries(N, 50_000, seed=0)
    assert k.dtype == np.int32
    assert k.min() >= 0 and k.max() < N and l.min() >= 0 and l.max() < N
    assert s.min() >= 1 and s.max() <= 64
    assert (k + s).max() <= N and (l + s).max() <= N
    assert set(np.unique(c)) == {0, 1, 2, 3, 4}
    assert np.array_equal(sweep_entries(N, 10, 3), sweep_entries(N, 10, 3))


def test_ext_round_checks_its_arguments(pair):
    _, tidx = pair
    fm = tidx.device(CPU)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown occ layout"):
        ext_round(fm, "bwd", z, z, z, z, layout="eta64")
    with pytest.raises(ValueError, match="unknown extension direction"):
        ext_round(fm, "up", z, z, z, z)
