"""SMEM's lockstep loop over compact state (``core.smem``): every round
against the dense (T, P) loop it replaced, and the output against the
scalar oracles and the JAX package's batched functions.

The dense loop is the benchmark's frozen copy (``bench.reference.
bwa_mem.smem``), imported as it is: its rounds pass through its module
global ``ext_round_ref``, the port's through ``core.smem.ext_round``.
Every value is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

from bench.reference.bwa_mem import fmindex as bfm
from bench.reference.bwa_mem import smem as bsm
from repro.core import fmindex as rfm
from repro.core import smem as rsm
from repro_torch import obs
from repro_torch.core import fmindex as tfm
from repro_torch.core import smem as tsm
from repro_torch.data import make_reference, simulate_reads
from repro_torch.kernels.fmocc import make_occ_fn

torch.set_num_threads(1)

LAYOUTS = ["eta32", "eta128"]


#: a 25-mer planted 25 times, followed by "AA" 5 times and by "CA" 20
#: times: a read starting "<TIE>AC" has the pass-1 SMEM [0, 26) (s = 5)
#: and the pass-3 seed [0, 26), whose s first falls below
#: ``max_mem_intv`` there
TIE = np.random.default_rng(0).integers(0, 4, 25).astype(np.uint8)


@pytest.fixture(scope="module")
def genome():
    ref = make_reference(12000, seed=5)
    for j in range(25):
        at = 200 + 400 * j
        ref[at:at + 27] = (*TIE, 0 if j < 5 else 1, 0)
    return ref, tfm.build_index(ref)


def batch_of_reads(ref, read_len: int, seed: int):
    """Reads of ``read_len`` with every kind of ambiguous base, and
    ``lens`` with some reads shorter than the batch width (the tail past
    a read's length holds bases the loop must not read); read 9 starts
    with ``TIE``."""
    reads, _ = simulate_reads(ref, 14, read_len, seed=seed)
    reads = reads.copy()
    reads[9, :27] = (*TIE, 0, 1)
    reads[0, 10:14] = 4            # a run of ambiguous bases
    reads[1, 0] = 4                # leading N
    reads[2, -1] = 4               # trailing N
    reads[3, ::17] = 4             # scattered Ns
    reads[4, :3] = 4               # a leading run
    reads[5, -5:] = 4              # a trailing run
    lens = np.full(len(reads), read_len, np.int64)
    lens[6] = read_len - 7
    lens[7] = read_len // 2
    lens[8] = 0                    # nothing to seed
    reads[7, read_len // 2 - 1] = 4    # a trailing N before the cut
    return reads, lens


def tasks(reads, lens, seed: int):
    """smem1 tasks at random starts, min_intv 1..6 (pass 2's are s + 1),
    some at x >= lens and on an ambiguous base."""
    rng = np.random.default_rng(seed)
    R, L = reads.shape
    t_read = rng.integers(0, R, 40)
    t_x = rng.integers(0, L, 40)
    t_mi = rng.integers(1, 7, 40)
    t_read[:3] = (8, 7, 3)         # x >= lens, past the cut, on an N
    t_x[:3] = (0, L - 1, 17)
    return t_read, t_x, t_mi


def record(rounds):
    """A wrapper of an ext_round that keeps copies of what it got."""
    def wrap(real):
        def rec(fm, which, k, l, s, c, **kw):
            rounds.append((which, *(t.numpy().copy() for t in (k, l, s, c))))
            return real(fm, which, k, l, s, c, **kw)
        return rec
    return wrap


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("read_len", [101, 151])
def test_rounds_equal_the_dense_loops(genome, layout, read_len, monkeypatch):
    ref, tidx = genome
    bidx = bfm.build_index(ref)
    reads, lens = batch_of_reads(ref, read_len, seed=2)
    t_read, t_x, t_mi = tasks(reads, lens, seed=3)
    occ_fn = make_occ_fn(layout, 256, "cpu")
    opt = tsm.MemOptions()
    mine, dense = [], []
    monkeypatch.setattr(tsm, "ext_round", record(mine)(tsm.ext_round))
    monkeypatch.setattr(bsm, "ext_round_ref",
                        record(dense)(bsm.ext_round_ref))
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        got = tsm.collect_smems_batch(tidx, reads, lens, opt, occ_fn=occ_fn)
        tb = tsm.smem1_batch(tidx, reads, lens, t_read, t_x, t_mi,
                             occ_fn=occ_fn)
    want = bsm.collect_smems_batch(bidx, reads, lens, bsm.MemOptions(),
                                   occ_fn=occ_fn)
    bb = bsm.smem1_batch(bidx, reads, lens, t_read, t_x, t_mi, occ_fn=occ_fn)
    assert got == want
    assert np.array_equal(tb.n, bb.n) and np.array_equal(tb.ret, bb.ret)
    # the same rounds, each with the same entries in the same order
    assert len(mine) == len(dense) > 0
    assert {r[0] for r in mine} == {"fwd", "bwd"}
    for a, b in zip(mine, dense):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype == np.int32
            assert np.array_equal(x, y)
    n = sum(len(r[1]) for r in mine)
    snap = reg.snapshot()
    assert snap["smem_rounds"] == len(mine)
    assert (snap["smem_h2d_bytes"], snap["smem_d2h_bytes"]) == (16 * n, 12 * n)
    assert snap["smem_live_entries"] == snap["smem_round_slots"] == n


def padded(batch: tsm.SmemTaskBatch, T: int):
    """Each task's SMEM tuples from the ragged batch."""
    rows = list(zip(*(a.tolist() for a in (batch.k, batch.l, batch.s,
                                            batch.qbeg, batch.qend))))
    ends = np.cumsum(batch.n).tolist()
    assert len(ends) == T and batch.task.tolist() == sorted(batch.task)
    return [rows[a:b] for a, b in zip([0] + ends[:-1], ends)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("read_len", [101, 151])
@pytest.mark.parametrize("seed", [2, 9])
def test_output_equals_the_oracles(genome, layout, read_len, seed):
    ref, tidx = genome
    ridx = rfm.build_index(ref)
    reads, lens = batch_of_reads(ref, read_len, seed)
    occ_fn = make_occ_fn(layout, 256, "cpu")
    opt = tsm.MemOptions()
    ropt = rsm.MemOptions()

    got = tsm.collect_smems_batch(tidx, reads, lens, opt, occ_fn=occ_fn)
    assert got == rsm.collect_smems_batch(ridx, reads, lens, ropt)
    assert got == [tsm.collect_smems(tidx, reads[r, :lens[r]], opt)
                   for r in range(len(reads))]
    # a span found twice (here a pass-3 seed on a pass-1 SMEM) ties in
    # (qbeg, qend); a span has one interval, so ties hold equal tuples,
    # kept as often as found
    assert [m for m in got[9] if m[3:] == (0, 26)] == \
        [got[9][0][:3] + (0, 26)] * 2 and got[9][0][2] == 5

    t_read, t_x, t_mi = tasks(reads, lens, seed + 1)
    tb = tsm.smem1_batch(tidx, reads, lens, t_read, t_x, t_mi,
                         occ_fn=occ_fn)
    rb = rsm.smem1_batch(ridx, reads, lens, t_read, t_x, t_mi)
    per_task = padded(tb, len(t_read))
    assert np.array_equal(tb.n, rb.n) and np.array_equal(tb.ret, rb.ret)
    for t, (r, x, mi) in enumerate(zip(t_read, t_x, t_mi)):
        want = [tuple(int(v) for v in (rb.k[t, m], rb.l[t, m], rb.s[t, m],
                                       rb.qbeg[t, m], rb.qend[t, m]))
                for m in range(rb.n[t])]
        assert per_task[t] == want
        if x < lens[r]:
            mems, ret = tsm.smem1(tidx, reads[r, :lens[r]], int(x), int(mi))
            assert (per_task[t], int(tb.ret[t])) == (mems, ret)

    out, has, ret = tsm.seed_strategy1_batch(
        tidx, reads, lens, t_read, t_x, opt.min_seed_len, opt.max_mem_intv,
        occ_fn=occ_fn)
    rout, rhas, rret = rsm.seed_strategy1_batch(
        ridx, reads, lens, t_read, t_x, opt.min_seed_len, opt.max_mem_intv)
    assert np.array_equal(has, rhas) and np.array_equal(ret, rret)
    assert np.array_equal(out[has], np.asarray(rout)[rhas])
    assert not out[~has].any()
    for t, (r, x) in enumerate(zip(t_read, t_x)):
        if x < lens[r]:
            m, nx = tsm.seed_strategy1(tidx, reads[r, :lens[r]], int(x),
                                       opt.min_seed_len, opt.max_mem_intv)
            assert (tuple(out[t].tolist()) if has[t] else None,
                    int(ret[t])) == (m, nx)
