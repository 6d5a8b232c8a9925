"""The diagseed kernel's plain PyTorch version (``kernels/diagseed/ref.py``,
through the pipeline's entry ``diag_seed_batch`` on the CPU) against the
JAX package's host function ``repro.pe.rescue.best_diag_seed``, candidate
by candidate, by exact equality:

* random windows with runs of the mate planted in them;
* ties across diagonals (the smallest diagonal wins) and within one
  diagonal (the leftmost run wins);
* N (code 4) in the mate and in the reference, never a match;
* windows shorter than ``min_len`` and shorter than the mate, mates
  shorter than ``min_len``;
* a 20-kbp window (``max_ins`` stats at their widest);
* an empty candidate list.

Also: the plain version's slices give the same answers however narrow
they are, a run of candidates sharing one mate packs its bytes once, the
host function ``host_diag_seeds`` is ``best_diag_seed`` row by row, and
the wrapper refuses a device it has no kernel for.
"""

import numpy as np
import pytest
import torch

from repro.pe import rescue as rrescue
from repro_torch import kernels
from repro_torch.kernels.diagseed import diag_seed_batch, diagseed_call
from repro_torch.kernels.diagseed import ops as dops
from repro_torch.kernels.diagseed import ref as dref
from repro_torch.pe.rescue import host_diag_seeds

torch.set_num_threads(1)

MIN_LEN = 10


def reference_rows(queries, S, wlos, whis, min_len):
    """The reference's answer of each candidate as (d, j_end, len) rows,
    len 0 where it finds no seed."""
    out = np.zeros((len(queries), 3), np.int64)
    for k, (q, lo, hi) in enumerate(zip(queries, wlos, whis)):
        seed = rrescue.best_diag_seed(q, S, lo, hi, min_len)
        if seed is not None:
            rb, qb, ln = seed
            out[k] = (rb - lo - qb, qb + ln - 1, ln)
    return out


def codes(rng, n, p_n=0.0):
    x = rng.integers(0, 4, n).astype(np.uint8)
    if p_n:
        x[rng.random(n) < p_n] = 4
    return x


def plant(S, lo, d, q, jb, je):
    """The mate's q[jb:je) on diagonal d of the window at lo, with a
    mismatch on each side, so that the run is exactly je - jb long."""
    S[lo + d + jb:lo + d + je] = q[jb:je]
    if jb > 0:
        S[lo + d + jb - 1] = (q[jb - 1] + 1) % 4
    if je < len(q):
        S[lo + d + je] = (q[je] + 1) % 4


def planted(rng):
    """Mates of 60-160 bases whose runs of 10-80 bases are copied into
    random windows of 200-1,200 bases, with a few mismatches each."""
    S = codes(rng, 60_000)
    queries, wlos, whis = [], [], []
    for _ in range(48):
        L = int(rng.integers(60, 161))
        q = codes(rng, L)
        n = int(rng.integers(200, 1_201))
        lo = int(rng.integers(0, len(S) - n))
        for _ in range(int(rng.integers(1, 4))):
            run = int(rng.integers(10, min(80, L) + 1))
            qb = int(rng.integers(0, L - run + 1))
            at = lo + int(rng.integers(0, n - run + 1))
            S[at:at + run] = q[qb:qb + run]
            S[at + int(rng.integers(0, run))] ^= 1
        queries.append(q)
        wlos.append(lo)
        whis.append(lo + n)
    return queries, S, wlos, whis, MIN_LEN


def ties(rng):
    """Equal longest runs on two diagonals (the smaller one must win,
    also when the larger's run ends first) and twice on one diagonal (the
    leftmost must win)."""
    S = codes(rng, 5_000)
    q = codes(rng, 120)
    queries, wlos, whis = [], [], []
    # across: a 30-run at diagonal 40 (ending at j 99) and at diagonal 300
    # (ending at j 49)
    lo = 1_000
    plant(S, lo, 40, q, 70, 100)
    plant(S, lo, 300, q, 20, 50)
    queries.append(q)
    wlos.append(lo)
    whis.append(lo + 600)
    # within: two 25-runs on diagonal 17, broken by a mismatch
    lo = 3_000
    plant(S, lo, 17, q, 5, 30)
    plant(S, lo, 17, q, 60, 85)
    queries.append(q)
    wlos.append(lo)
    whis.append(lo + 500)
    return queries, S, wlos, whis, MIN_LEN


def ambiguous(rng):
    """N in the mate and in the reference, on both sides of planted runs:
    an N against an N is no match."""
    S = codes(rng, 20_000, p_n=0.02)
    queries, wlos, whis = [], [], []
    for k in range(32):
        q = codes(rng, 151, p_n=0.03)
        lo = 500 * k
        at = lo + int(rng.integers(0, 300))
        S[at:at + 151] = q                 # the mate's own Ns copied too
        queries.append(q)
        wlos.append(lo)
        whis.append(lo + 450)
    q = np.full(40, 4, np.uint8)            # all N, against all N
    S[19_000:19_100] = 4
    queries.append(q)
    wlos.append(19_000)
    whis.append(19_100)
    return queries, S, wlos, whis, MIN_LEN


def short(rng):
    """Windows shorter than ``min_len`` and than the mate, mates shorter
    than ``min_len``, and windows at the reference's end."""
    S = codes(rng, 4_000)
    q = S[2_000:2_151].copy()
    queries = [q, q, q, q[:9], q[:10], q[:10], q, codes(rng, 5)]
    wlos = [2_000, 2_000, 1_990, 2_000, 2_000, 1_995, 3_900, 100]
    whis = [2_009, 2_010, 2_100, 2_200, 2_001, 2_010, 4_000, 120]
    return queries, S, wlos, whis, MIN_LEN


def wide(rng):
    """One 20-kbp window with the mate's best run near its far end, and a
    few ordinary windows around it."""
    S = codes(rng, 80_000)
    q = codes(rng, 151)
    plant(S, 30_000, 19_660, q, 40, 130)
    queries = [q, q, codes(rng, 151), q]
    wlos = [1_000, 30_000, 55_000, 29_000]
    whis = [1_800, 50_000, 55_785, 29_900]
    return queries, S, wlos, whis, MIN_LEN


def empty(rng):
    return [], codes(rng, 1_000), [], [], MIN_LEN


CASES = {"planted": planted, "ties": ties, "ambiguous": ambiguous,
         "short": short, "wide": wide, "empty": empty}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_reference(case):
    queries, S, wlos, whis, min_len = CASES[case](np.random.default_rng(31))
    want = reference_rows(queries, S, wlos, whis, min_len)
    got = diag_seed_batch(queries, S, wlos, whis, min_len, device="cpu")
    assert got.dtype == np.int64 and got.shape == (len(queries), 3)
    np.testing.assert_array_equal(got, want)
    hits = int((want[:, 2] > 0).sum())
    if case in ("planted", "ambiguous", "ties"):
        assert hits >= len(queries) // 2, hits
    if case == "ties":
        assert want.tolist() == [[40, 99, 30], [17, 29, 25]]
    if case == "wide":
        assert want[1].tolist() == [19_660, 129, 90]


def test_host_diag_seeds_is_best_diag_seed():
    queries, S, wlos, whis, min_len = planted(np.random.default_rng(5))
    np.testing.assert_array_equal(
        host_diag_seeds(queries, S, wlos, whis, min_len),
        reference_rows(queries, S, wlos, whis, min_len))


@pytest.mark.parametrize("cells", [1, 700, 5_000])
def test_slices_do_not_change_answers(monkeypatch, cells):
    """Slices of one candidate each, of a few, and of many."""
    queries, S, wlos, whis, min_len = planted(np.random.default_rng(8))
    want = reference_rows(queries, S, wlos, whis, min_len)
    monkeypatch.setattr(dref, "SLICE_CELLS", cells)
    assert len(dref._slices([hi - lo for lo, hi in zip(wlos, whis)],
                            [len(q) for q in queries])) > 1
    got = diag_seed_batch(queries, S, wlos, whis, min_len, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_pack_shares_a_mate_and_gathers_windows():
    rng = np.random.default_rng(3)
    S = codes(rng, 1_000)
    a, b = codes(rng, 7), codes(rng, 5)
    win, woff, wlen, mates, moff, mlen = dops.pack(
        [a, a, b, a], S, [10, 500, 0, 990], [14, 503, 2, 1_000])
    assert win.tolist() == (S[10:14].tolist() + S[500:503].tolist()
                            + S[0:2].tolist() + S[990:1_000].tolist())
    assert woff.tolist() == [0, 4, 7, 9] and wlen.tolist() == [4, 3, 2, 10]
    # a run of one mate array holds its bytes once; a later run again
    assert mates.tolist() == a.tolist() + b.tolist() + a.tolist()
    assert moff.tolist() == [0, 0, 7, 12] and mlen.tolist() == [7, 7, 5, 7]
    assert dops.stage_bytes(wlen, mlen).tolist() == [20, 19, 18, 26]


def test_smem_bytes_leaves_wide_windows_to_device_memory():
    over = dops.SMEM_CTA_MAX
    assert dops.smem_bytes([785, 20_000], [151, 151]) == 20_160
    assert dops.smem_bytes([over, 785], [151, 151]) == 785 + 160
    assert dops.smem_bytes([over], [151]) == 0


def test_wrapper_refuses_other_devices():
    before = kernels.launch_counts()
    u8 = torch.zeros(4, dtype=torch.uint8, device="meta")
    i64 = torch.zeros(1, dtype=torch.int64, device="meta")
    i32 = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        diagseed_call(u8, i64, i32, u8, i64, i32, MIN_LEN)
    S = np.zeros(100, np.uint8)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        diag_seed_batch([S[:20]], S, [0], [50], MIN_LEN, device="meta")
    assert kernels.launch_counts() == before
    assert "diagseed" in before
