"""SMEM and SAL of the port against the reference: the lockstep batch
with its rounds on a torch device (the plain fmocc path on the CPU) in
both occ layouts, and the SA gather.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from repro.core import fmindex as rfm
from repro.core import sal as rsal
from repro.core import smem as rsm
from repro_torch import obs
from repro_torch.core import fmindex as tfm
from repro_torch.core import sal as tsal
from repro_torch.core import smem as tsm
from repro_torch.data import make_reference, simulate_reads
from repro_torch.kernels.fmocc import OccConfig

torch.set_num_threads(1)


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


@pytest.fixture(scope="module")
def ref_mems(world):
    ridx, _, reads = world
    lens = np.full(len(reads), reads.shape[1], np.int64)
    return rsm.collect_smems_batch(ridx, reads, lens, rsm.MemOptions())


@pytest.mark.parametrize("layout", ["eta32", "eta128"])
def test_collect_smems_batch_equals_reference(world, ref_mems, layout):
    ridx, tidx, reads = world
    lens = np.full(len(reads), reads.shape[1], np.int64)
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        got = tsm.collect_smems_batch(tidx, reads, lens, tsm.MemOptions(),
                                      occ=OccConfig(layout, 256, "cpu"))
    assert got == ref_mems
    # and per read, the scalar oracle of the reference
    opt = rsm.MemOptions()
    assert got == [rsm.collect_smems(ridx, reads[r], opt)
                   for r in range(len(reads))]
    snap = reg.snapshot()
    assert snap["smem_rounds"] > 0
    assert snap["smem_h2d_bytes"] > 0 and snap["smem_d2h_bytes"] > 0


def test_collect_smems_batch_needs_a_device_occ_fn(world):
    # no host backend to fall back on: the caller names the round
    # kernel's configuration, and with it the device the rounds run on
    _, tidx, reads = world
    lens = np.full(len(reads), reads.shape[1], np.int64)
    with pytest.raises(TypeError):
        tsm.collect_smems_batch(tidx, reads, lens, tsm.MemOptions())


def test_frac_rep_equals_reference(ref_mems):
    for mems in ref_mems:
        for max_occ in (1, 3, 500):
            assert tsm.frac_rep(mems, 101, max_occ) == \
                rsm.frac_rep(mems, 101, max_occ)


@pytest.mark.parametrize("max_occ", [500, 2])
def test_seeds_from_intervals_equals_reference(world, ref_mems, max_occ):
    ridx, tidx, _ = world
    want = rsal.seeds_from_intervals(ridx, ref_mems, max_occ)
    got = tsal.seeds_from_intervals(tidx, ref_mems, max_occ, device="cpu")
    assert got == want


def test_sal_empty_and_direct(world):
    _, tidx, _ = world
    assert tsal.seeds_from_intervals(tidx, [[], []], 500,
                                     device="cpu") == ([[], []], 0)
    fm = tidx.device("cpu")
    rows = torch.tensor([0, 5, int(tidx.N) - 1])
    assert tsal.sal_direct(fm, rows).tolist() == \
        [int(tidx.sa[r]) for r in rows.tolist()]
