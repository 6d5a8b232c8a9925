"""The galign kernel's plain PyTorch version (``kernels/galign/ref.py``)
against the JAX package's host function ``repro.core.sam.
global_align_cigar``, score and CIGAR, by exact equality:

* a seeded random sweep (n, m in 0-300, w in 1-120, codes 0-4 with N);
* ``n == 0``, ``m == 0`` and ``|n - m| > w``;
* inputs built so that the best path lies off the band: the reference's
  out-of-band corner branch is counted (``sys.monitoring`` on its
  lines) and is never reached, as no cell in the band can lead there;
* every region that finalize emits on the SE and PE golden suites, the
  rescued mates included.

Also: the ``cuda`` engine on the CPU finalizes each batch in one galign
call (SE; PE adds one for the rescued mates) while the ``baseline``
engine makes none, and the wrapper refuses what it cannot compute.
"""

import inspect
import sys

import numpy as np
import pytest
import torch

from repro.core import sam as rsam
from repro.core.bsw import BSWParams as RBSWParams
from repro_torch import kernels
from repro_torch.api import Aligner
from repro_torch.core.bsw import BSWParams
from repro_torch.core.contig import build_contig_index
from repro_torch.data import make_reference, simulate_pairs, simulate_reads
from repro_torch.kernels import galign
from repro_torch.kernels.galign import ops as gops
from repro_torch.options import AlignOptions

torch.set_num_threads(1)

PARAMS = [(BSWParams(), RBSWParams()),
          (BSWParams(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=3),
           RBSWParams(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=3))]


def run_ref(tasks, p):
    """The plain version through the wrapper on CPU tensors."""
    args = [torch.from_numpy(a) for a in gops.pack(tasks)]
    return gops.unpack(*galign.galign_call(*args, p))


def assert_equal_to_reference(tasks, pi=0):
    p, rp = PARAMS[pi]
    got = run_ref(tasks, p)
    for k, ((q, t, w), (score, cig)) in enumerate(zip(tasks, got)):
        want = rsam.global_align_cigar(q, t, w, rp)
        assert (score, cig) == want, (k, len(q), len(t), w)


def mutated(rng, t, n):
    """A query of ``n`` codes read from ``t`` with substitutions, N and
    short indels."""
    q = list(t[:n]) + list(rng.integers(0, 5, max(0, n - len(t))))
    for _ in range(int(rng.integers(0, 4))):
        at = int(rng.integers(0, max(len(q), 1)))
        if rng.random() < 0.5:
            q[at:at] = list(rng.integers(0, 4, int(rng.integers(1, 6))))
        else:
            del q[at:at + int(rng.integers(1, 6))]
    q = np.array(q[:n] + list(rng.integers(0, 4, max(0, n - len(q)))),
                 np.int64)
    sub = rng.random(n) < 0.08
    q[sub] = rng.integers(0, 5, int(sub.sum()))
    return q


@pytest.mark.parametrize("seed", range(6))
def test_ref_equals_reference_on_a_seeded_sweep(seed):
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(12):
        m = int(rng.integers(0, 301))
        n = int(np.clip(m + rng.integers(-40, 41), 0, 300)) \
            if rng.random() < 0.8 else int(rng.integers(0, 301))
        t = rng.integers(0, 5, m)
        q = mutated(rng, t, n) if rng.random() < 0.8 else \
            rng.integers(0, 5, n)
        tasks.append((q, t, int(rng.integers(1, 121))))
    assert_equal_to_reference(tasks, pi=seed % 2)


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_ref_equals_reference_on_edge_cases(pi):
    rng = np.random.default_rng(17)
    r = lambda k: rng.integers(0, 5, k)          # noqa: E731
    tasks = [(r(0), r(0), 5), (r(0), r(7), 1), (r(9), r(0), 3),
             (r(1), r(1), 1), (r(1), r(40), 2), (r(40), r(1), 2),
             (r(60), r(10), 5), (r(10), r(60), 5), (r(33), r(2), 120),
             (np.full(20, 4), np.full(25, 4), 1)]
    # |n - m| > w in every one of these but the 1-by-1 and the all-N
    assert sum(abs(len(q) - len(t)) > w for q, t, w in tasks) >= 7
    assert_equal_to_reference(tasks, pi)


def off_band_tasks():
    """Queries whose best alignment lies on another diagonal than the
    band allows: a shifted copy of the target (offset 5-40 against a
    half-width of 1-4), and an insertion then a deletion of k bases with
    n == m, so the band (|n - m| + 3 = 3) cannot follow the path."""
    rng = np.random.default_rng(5)
    tasks = []
    for _ in range(16):
        L, s = int(rng.integers(30, 150)), int(rng.integers(5, 41))
        t = rng.integers(0, 4, L)
        q = np.concatenate([t[s:], rng.integers(0, 4, s)])
        tasks.append((q, t, int(rng.integers(1, 5))))
    for _ in range(16):
        L, k = int(rng.integers(40, 150)), int(rng.integers(4, 20))
        t = rng.integers(0, 4, L)
        a = int(rng.integers(1, L - k))
        q = np.concatenate([t[:a], rng.integers(0, 4, k), t[a:L - k]])
        tasks.append((q, t, int(rng.integers(1, 4))))
    return tasks


def corner_hits(tasks, rp) -> int:
    """How many times the reference's traceback enters its out-of-band
    corner branch on ``tasks`` (``sys.monitoring`` LINE events on the
    branch's first line; every other line is disabled after its first
    event, so the DP runs at its own speed)."""
    fn = rsam.global_align_cigar
    lines, start = inspect.getsourcelines(fn)
    target = start + next(i for i, ln in enumerate(lines)
                          if "out-of-band corner" in ln) + 1
    assert "if i == 0" in lines[target - start]
    mon = sys.monitoring
    tool = next(i for i in range(6) if mon.get_tool(i) is None)
    hits = [0]

    def on_line(code, line):
        if line == target:
            hits[0] += 1
            return None
        return mon.DISABLE

    mon.use_tool_id(tool, "galign-corner-count")
    try:
        mon.register_callback(tool, mon.events.LINE, on_line)
        mon.set_local_events(tool, fn.__code__, mon.events.LINE)
        for q, t, w in tasks:
            fn(q, t, w, rp)
    finally:
        mon.set_local_events(tool, fn.__code__, 0)
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
        mon.restart_events()
    return hits[0]


def test_off_band_paths_and_the_corner_branch():
    tasks = off_band_tasks()
    assert_equal_to_reference(tasks)
    # the traceback hugs the band's edge: some CIGARs carry the indels
    # the band forced, far from the shifted copy's best path
    got = run_ref(tasks, PARAMS[0][0])
    assert sum(any(op != "M" for _, op in cig) for _, cig in got) >= 16
    # every cell in the band equals one of M, E, F, and every cell off it
    # holds NEG in H and E alike (an E step), so the corner branch is
    # unreachable: 0 of these 32 tasks (and of the edge cases) reach it
    assert corner_hits(tasks, PARAMS[0][1]) == 0
    rng = np.random.default_rng(17)
    assert corner_hits([(rng.integers(0, 5, 30), rng.integers(0, 5, 4), 1),
                        (rng.integers(0, 5, 3), rng.integers(0, 5, 25), 2)],
                       PARAMS[0][1]) == 0


# ---------------------------- the golden suites ----------------------------

def recorded_tasks(monkeypatch, run):
    """``run()``'s finalize tasks, call by call, from the galign entry
    the pipeline looks up on ``kernels.galign`` at each call."""
    calls = []
    real = galign.global_align_batch

    def recording(tasks, p, *, device):
        calls.append(list(tasks))
        return real(tasks, p, device=device)
    monkeypatch.setattr(galign, "global_align_batch", recording)
    run()
    return calls


def test_every_emitted_region_of_the_se_golden(monkeypatch):
    ref = make_reference(12000, seed=7)
    reads, _ = simulate_reads(ref, 8, 101, seed=3)
    al = Aligner(build_contig_index([("ref", ref)]),
                 AlignOptions(device="cpu"))
    calls = recorded_tasks(monkeypatch, lambda: al.align(reads))
    assert len(calls) == 1 and len(calls[0]) >= 8
    assert_equal_to_reference(calls[0])


def test_every_emitted_region_of_the_pe_golden(monkeypatch):
    ref = make_reference(30_000, seed=5)
    r1, r2, _ = simulate_pairs(ref, 48, 101, insert_mean=300,
                               insert_std=30, seed=9, burst_frac=0.25)
    al = Aligner(build_contig_index([("ref", ref)]),
                 AlignOptions(device="cpu"))
    res = {}
    calls = recorded_tasks(monkeypatch,
                           lambda: res.update(r=al.align_pairs(r1, r2)))
    # both ends' regions in one call, the rescued mates in a second
    assert len(calls) == 2
    assert len(calls[0]) >= 96
    assert len(calls[1]) == res["r"].stats["n_rescued"] > 0
    assert_equal_to_reference(calls[0] + calls[1])


def test_the_baseline_engine_makes_no_galign_call():
    ref = make_reference(12000, seed=7)
    reads, _ = simulate_reads(ref, 8, 101, seed=3)
    idx = build_contig_index([("ref", ref)])
    kernels.reset_launch_counts()
    got = {e: Aligner(idx, AlignOptions(engine=e, device="cpu"),
                      telemetry=True).align(reads)
           for e in ("cuda", "baseline")}
    assert got["cuda"].sam() == got["baseline"].sam()
    assert got["cuda"].stats["kernel_galign_dispatches"] == 1
    assert "kernel_galign_dispatches" not in got["baseline"].stats
    assert got["cuda"].stats["time_kernel.galign_s"] > 0
    # the CPU runs the plain version: no kernel launched on either engine
    assert kernels.launch_counts()["galign"] == 0


# ------------------------------- the wrapper -------------------------------

def test_the_wrapper_refuses_what_it_cannot_compute():
    p = BSWParams()
    args = [torch.from_numpy(a) for a in
            gops.pack([(np.zeros(5, np.int64), np.zeros(6, np.int64), 2)])]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        galign.galign_call(*(a.to("meta") for a in args), p)
    with pytest.raises(ValueError, match="int32"):
        gops.check_range(torch.tensor([1 << 26]), torch.tensor([1 << 26]), p)
    with pytest.raises(RuntimeError, match="leaves the band"):
        gops.unpack(torch.tensor([0]), torch.tensor([-1]),
                    torch.zeros((1, 1), dtype=torch.int32))
    assert galign.global_align_batch([], p, device="cpu") == []
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        galign.global_align_batch([(np.zeros(5, np.int64),
                                    np.zeros(6, np.int64), 2)], p,
                                  device="meta")


# ------------------------------ the host plan ------------------------------

def _up16(x):
    return (x + 15) // 16 * 16


# (tasks as (n, m, w), then by hand: the runs' stride, k, a warp's
# shared-memory slot, tasks on the shared / global / wide paths, global
# scratch bytes, wide row int32).  A slot is n RB bytes of decisions, RB =
# ceil(W / k) k / 2 with W = min(m, 2 max(w, |n - m| + 3) + 1), then
# 4 (n + m) bytes of runs, each rounded up to 16; k is the least power of
# two from 2 with 32 k > W.
PLAN_CASES = {
    # n == 0 and m == 0 take the shared path with no slot
    "n0": ([(0, 7, 1)], 7, 2, 0, (1, 0, 0), 0, 0),
    "m0": ([(9, 0, 3)], 9, 2, 0, (1, 0, 0), 0, 0),
    # w = 1 on n = m = 60: w 3, W 7, RB 4: 240 + 480 = 720
    "w1": ([(60, 60, 1)], 120, 2, 720, (1, 0, 0), 0, 0),
    # |n - m| > w: w = 42, W = min(1, 85) = 1, RB 1: 48 + 164 -> 224
    "gap": ([(40, 1, 2)], 41, 2, 224, (1, 0, 0), 0, 0),
    # a 101-base read on the BSW band: W 101, k 4, RB 52: 5264 + 808
    "read101": ([(101, 101, 100)], 202, 4, 6080, (1, 0, 0), 0, 0),
    # W 21, RB 11: 33,638 -> 33,648, + 24,464 = 58,112 = SLOT_MAX
    "at_limit": ([(3058, 3058, 10)], 6116, 2, 58112, (1, 0, 0), 0, 0),
    # one more base: 33,664 + 24,472 -> 58,144 bytes of global scratch
    "above_limit": ([(3059, 3059, 10)], 6118, 2, 0, (0, 1, 0), 58144, 0),
    # W = min(1030, 1201) >= 1,024: the wide path, 1031^2 -> 1,062,976
    # decision bytes and 4 x 1031 row int32
    "wide": ([(1030, 1030, 600)], 2060, 2, 0, (0, 0, 1), 1062976, 4124),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_hand_counts(case):
    tasks, stride, k, slot, paths, nbits, nrows = PLAN_CASES[case]
    n, m, w = (np.array(c, np.int32) for c in zip(*tasks))
    pl = gops.plan(n, m, w)
    assert (pl.stride, pl.k, pl.slot) == (stride, k, slot)
    assert (pl.n_smem, pl.n_global, pl.n_wide) == paths
    assert (pl.nbits, pl.nrows) == (nbits, nrows)
    assert pl.smem_cta == gops.WARPS * slot
    assert gops.SLOT_MAX == 58112 and gops.WARPS * gops.SLOT_MAX <= 232448


def test_plan_orders_paths_longest_first_and_packs_scratch():
    tasks = [(101, 101, 100), (0, 5, 1), (3059, 3059, 10), (1030, 1030, 600),
             (150, 150, 100), (3100, 3100, 10), (60, 60, 1)]
    n, m, w = (np.array(c, np.int32) for c in zip(*tasks))
    pl = gops.plan(n, m, w)
    # shared (slot largest first, the empty task last), global, wide
    assert pl.order.tolist() == [4, 0, 6, 1, 5, 2, 3]
    assert (pl.n_smem, pl.n_global, pl.n_wide) == (4, 2, 1)
    # k 8 for the widest shared-or-global band (W 151 needs 32 k > 151);
    # task 4's slot: RB = ceil(151 / 8) 4 = 76, 150 x 76 = 11,400 + 1,200
    assert pl.k == 8 and pl.slot == 12608
    # global slots at k 8: RB = ceil(21 / 8) 4 = 12
    g2 = _up16(_up16(3059 * 12) + 4 * 6118)
    g5 = _up16(_up16(3100 * 12) + 4 * 6200)
    wide = _up16(1031 * 1031)
    # the global scratch holds them in task order, disjoint
    assert pl.boff[[2, 3, 5]].tolist() == [0, g2, g2 + wide]
    assert pl.nbits == g2 + g5 + wide
    assert pl.roff[3] == 0 and pl.nrows == 4 * 1031


def test_plan_is_host_only_and_guards_int32():
    pl = gops.plan([], [], [])
    assert (pl.stride, pl.most, pl.n_smem, pl.nbits) == (1, 0, 0, 0)
    p = BSWParams()
    gops.check_range(None, None, p, most=pl.most)
    with pytest.raises(ValueError, match="int32"):
        gops.check_range(None, None, p, most=1 << 26)
    with pytest.raises(ValueError, match="signed byte"):
        gops.check_range([1], [1], BSWParams(a=200))
    x = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        gops.galign_launch(x.to(torch.uint8)[None], x.to(torch.uint8)[None],
                           x, x, x, p, gops.plan([1], [1], [1]))


# ------------------------- the synthetic long sets -------------------------

def related_tasks(rng, count, lo, hi, span, wlo, whi):
    """``count`` tasks: queries of lo..hi - 1 bases, targets that copy
    them with ~5% substitutions and differ in length by up to ``span``,
    half-widths wlo..whi - 1."""
    tasks = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        m = n + int(rng.integers(-span, span + 1))
        q = rng.integers(0, 4, n)
        t = rng.integers(0, 4, m)
        k = min(n, m)
        t[:k] = np.where(rng.random(k) < 0.05, rng.integers(0, 4, k), q[:k])
        tasks.append((q, t, int(rng.integers(wlo, whi))))
    return tasks


@pytest.mark.parametrize("name", ["long_narrow", "global_path", "wide"])
def test_wrapper_on_cpu_equals_reference_on_the_long_sets(name):
    """The sets the card's phase 4 adds, cut to a few tasks: long tasks on
    a narrow band, tasks past a warp's shared-memory slot, and a band of
    1,024 columns or more.  On CPU tensors the wrapper is the plain
    version, equal to the reference's host function."""
    rng = np.random.default_rng({"long_narrow": 41, "global_path": 42,
                                 "wide": 43}[name])
    tasks = {"long_narrow": lambda: related_tasks(rng, 3, 400, 1001, 8, 1,
                                                  21),
             "global_path": lambda: related_tasks(rng, 1, 3100, 3201, 4, 10,
                                                  16),
             "wide": lambda: related_tasks(rng, 1, 1030, 1040, 4, 600,
                                           601)}[name]()
    pl = gops.plan(*gops.pack(tasks)[2:])
    want_path = {"long_narrow": 0, "global_path": 1, "wide": 2}[name]
    assert [pl.n_smem, pl.n_global, pl.n_wide][want_path] == len(tasks)
    args = [torch.from_numpy(a) for a in gops.pack(tasks)]
    got = galign.galign_call(*args, BSWParams())
    want = galign.ops.galign_ref(*args, BSWParams())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert_equal_to_reference(tasks)
