"""The host occ oracle of a loaded bundle is built on first use, never by
the load: the ``cuda`` engine's mem path (here on ``device="cpu"``) leaves
it unbuilt and writes the ``baseline`` engine's SAM, and the oracle's
values (``occ``, ``backward_ext``, ``sa_lookup_compressed``) are those of a
freshly built index.  Every value is an integer, so equality is exact."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import Aligner
from repro_torch.core import fmindex as tfm
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (simulate_pairs_multi, simulate_reads_multi,
                              simulate_reference)
from repro_torch.io.store import load_index, save_index
from repro_torch.options import AlignOptions

torch.set_num_threads(1)

CUDA_ON_CPU = AlignOptions(device="cpu")
BASELINE = AlignOptions(engine="baseline", device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    contigs = simulate_reference(30000, 3, seed=11)
    built = build_contig_index(contigs)
    prefix = tmp_path_factory.mktemp("bundle") / "ref"
    save_index(prefix, built)
    return contigs, built, prefix


def probes(idx, n=400, seed=5):
    """Row indices over the whole BWT, with its ends and the primary."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, idx.N, n).tolist()
    return rows + [0, 1, idx.primary, idx.N - 1]


def test_a_loaded_bundle_has_no_oracle(world):
    _, built, prefix = world
    assert built._occ_prefix is not None
    loaded = load_index(prefix)
    assert loaded._occ_prefix is None
    assert loaded.names == built.names


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_cuda_engine_leaves_the_oracle_unbuilt(world, paired):
    contigs, _, prefix = world
    cuda_al = Aligner.from_bundle(prefix, CUDA_ON_CPU)
    if paired:
        r1, r2, _ = simulate_pairs_multi(contigs, 48, 101, insert_mean=300,
                                         insert_std=30, seed=17)
        got = cuda_al.align_pairs(r1, r2).sam()
    else:
        reads, _ = simulate_reads_multi(contigs, 10, 101, seed=13)
        got = cuda_al.align(reads).sam()
    assert cuda_al.index._occ_prefix is None
    base_al = Aligner.from_bundle(prefix, BASELINE)
    want = (base_al.align_pairs(r1, r2) if paired
            else base_al.align(reads)).sam()
    assert base_al.index._occ_prefix is not None
    assert got == want


def test_first_occ_builds_the_oracle(world):
    _, built, prefix = world
    loaded = load_index(prefix)
    i = int(loaded.N) // 3
    assert loaded.occ(2, -1) == 0 and loaded._occ_prefix is None
    assert loaded.occ(2, i) == built.occ(2, i)
    table = loaded._occ_prefix
    assert table.dtype == np.int64 and table.shape == (loaded.N + 1, 4)
    assert np.array_equal(table, tfm.occ_prefix_from_bwt(loaded.bwt))
    assert np.array_equal(table, built._occ_prefix)
    loaded.occ(1, i)
    assert loaded._occ_prefix is table


def test_oracle_values_equal_a_fresh_build(world):
    _, built, prefix = world
    loaded = load_index(prefix)
    rows = probes(built)
    for c in range(4):
        for i in [-1] + rows:
            assert loaded.occ(c, i) == built.occ(c, i), (c, i)
    rng = np.random.default_rng(9)
    for _ in range(300):
        k = int(rng.integers(0, built.N))
        s = int(rng.integers(0, min(64, built.N - k) + 1))
        l = int(rng.integers(0, built.N))
        c = int(rng.integers(0, 5))
        assert loaded.backward_ext(k, l, s, c) == \
            built.backward_ext(k, l, s, c), (k, l, s, c)
        assert loaded.forward_ext(k, l, s, c) == \
            built.forward_ext(k, l, s, c), (k, l, s, c)
    for i in rows:
        assert loaded.sa_lookup_compressed(i) == \
            built.sa_lookup_compressed(i), i


def test_two_threads_build_the_oracle_once(world, monkeypatch):
    _, built, prefix = world
    loaded = load_index(prefix)
    builds = []
    real = tfm.occ_prefix_from_bwt

    def slow(bwt):
        builds.append(threading.get_ident())
        time.sleep(0.2)          # both threads reach the lock meanwhile
        return real(bwt)

    monkeypatch.setattr(tfm, "occ_prefix_from_bwt", slow)
    start = threading.Barrier(2)
    i = int(loaded.N) - 2
    got = [None, None]

    def ask(j):
        start.wait()
        got[j] = loaded.occ(3, i)

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert got == [built.occ(3, i)] * 2


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")


@pytest.mark.card
def test_sal_gather_is_timed_on_the_card(card, world):
    """Every SAL gather of a traced run is one ``sal`` device event, and
    the card's SAM is the CPU's."""
    from repro_torch import obs
    contigs, _, prefix = world
    r1, r2, _ = simulate_pairs_multi(contigs, 48, 101, insert_mean=300,
                                     insert_std=30, seed=17)
    tele = obs.Telemetry(trace=True)
    al = Aligner.from_bundle(prefix, device=card, telemetry=tele)
    res = al.align_pairs(r1, r2)
    torch.cuda.synchronize(card)
    st = res.stats
    events = [e for e in tele.tracer.device_events if e["name"] == "sal"]
    print(f"[sal_span] dispatches {st['sal_dispatches']}, rows "
          f"{st['sal_rows']}, device s {st['time_device_sal_s']:.6f}")
    assert len(events) == st["sal_dispatches"] > 0
    assert st["time_device_sal_s"] > 0 and st["sal_rows"] > 0
    assert al.index._occ_prefix is None
    want = Aligner.from_bundle(prefix, CUDA_ON_CPU).align_pairs(r1, r2)
    assert res.sam() == want.sam()
