"""The kernels' work counts against hand counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.frozen import work
from bench.reference.bwa_mem import obs
from bench.reference.bwa_mem.bsw import BSWParams, pack_tasks
from bench.reference.bwa_mem.bsw_ref import bsw_ref

P = BSWParams()


def test_ext_bound_hand_count():
    # k = 0 and 64, s = 1: positions 0, 1, 64, 65 -> eta32 buckets 0, 2
    # (2 rows) in count sectors 0, 1 (2 sectors): 2 x 28 + 32 x 4 bytes
    st = torch.tensor([[0, 64], [0, 64], [1, 1], [0, 0]], dtype=torch.int32)
    assert work.ext_bound_s(st, "bwd", "eta32") == pytest.approx(
        (2 * 28 + 32 * 4) / work.HBM_BYTES_PER_S)
    # eta128: both in bucket 0 -> 1 row, 1 sector
    assert work.ext_bound_s(st, "bwd", "eta128") == pytest.approx(
        (2 * 28 + 32 * 2) / work.HBM_BYTES_PER_S)
    # forward rounds read l's positions
    st2 = st.clone()
    st2[1] = torch.tensor([0, 0])
    assert work.ext_bound_s(st2, "fwd", "eta32") == pytest.approx(
        (2 * 28 + 32 * 2) / work.HBM_BYTES_PER_S)


def test_galign_cells_hand_count():
    q = lambda n: np.zeros(n, np.uint8)          # noqa: E731
    # n = m = 3, w = 0 -> band 3: every row all 3 columns
    assert work.galign_cells([(q(3), q(3), 0)]) == 9
    # n 5, m 2 -> band |5 - 2| + 3 = 6: every row both columns
    assert work.galign_cells([(q(5), q(2), 1)]) == 10
    # n 10, m 10, w 1 -> band 3: rows 1..10 hold min(10, i+3) -
    # max(1, i-3) + 1 = 4, 5, 6, 7, 7, 7, 7, 6, 5, 4
    assert work.galign_cells([(q(10), q(10), 1)]) == 58
    assert work.galign_cells([(q(0), q(4), 1)]) == 0


def test_bsw_cells_hand_count():
    q = np.zeros(5, np.uint8)
    # one target row: the band [max(0, -w), min(qlen, w + 1)) -> 3 cells
    assert work.bsw_cells_each([q], [q[:1]], [10], [2], P, "cpu")[0] == 3
    assert work.bsw_cells_each([q[:3]], [q[:1]], [10], [100], P,
                               "cpu")[0] == 3


def test_bsw_cells_agree_with_the_recurrences_own_count():
    rng = np.random.default_rng(4)
    qs = [rng.integers(0, 4, rng.integers(20, 90)) for _ in range(40)]
    ts = [np.concatenate([q[:len(q) // 2], rng.integers(0, 4, 30)])
          for q in qs]
    h0 = list(rng.integers(10, 40, 40))
    ws = [100] * 40
    each = work.bsw_cells_each(qs, ts, h0, ws, P, "cpu", block=7)
    with obs.counting() as counts:
        bsw_ref(*[torch.from_numpy(a) for a in
                  pack_tasks(qs, ts, h0, P, ws)], P)
    assert each.sum() == counts["bsw_cells_banded"] > 0


def test_bounds_take_the_longer_term():
    ops = 10 ** 6 * work.BSW_OPS_PER_CELL / work.INT32_OPS_PER_S
    assert work.bsw_bound_s(10 ** 6, 8, 128, 256) == pytest.approx(ops)
    nbytes = 4 * 8 * (128 + 256 + 4) + 4 * 6 * 8
    assert work.bsw_bound_s(0, 8, 128, 256) == pytest.approx(
        nbytes / work.HBM_BYTES_PER_S)
    q = np.zeros(10, np.uint8)
    assert work.galign_bound_s([(q, q, 1)], 58, 1) == pytest.approx(
        max(58 * 11 / work.INT32_OPS_PER_S,
            (20 + 12 + 8 + 4) / work.HBM_BYTES_PER_S))
