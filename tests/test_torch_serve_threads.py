"""The port's alignment service under threads, mirroring the concurrent
clients and the ``Aligner`` thread hammers of ``tests/test_serve.py``:
8 clients hammering one ``repro_torch.serve.AlignmentServer`` with SE and
PE requests, and N threads hammering one ``Aligner``.  Every response is
byte-identical to the offline ``stream_sam`` of the port
(``device="cpu"``) and of the reference (``pallas`` engine).

The hammers race the lazy per-index state the server's shared aligners
stand on, each behind one lock of the port:

* ``kernels.engine._ATTACH_LOCK`` — the occ-layout sweep, cached on the
  index once per device;
* ``core.fmindex._DEVICE_LOCK`` — the index's tensors on the device,
  uploaded once per device;
* ``kernels.build._LOCK`` and ``kernels.build.LAUNCH_LOCK`` — the kernel
  library's build and the launch counters, which only a CUDA launch
  reaches: on the CPU path no thread may count a launch.
"""

from __future__ import annotations

import io
import sys
import threading

import pytest
import torch

from repro.api import Aligner as RAligner
from repro.core import fmindex as rfmx
from repro.io.stream import _pack_pe as r_pack_pe
from repro.io.stream import _pack_se as r_pack_se
from repro.options import AlignOptions as RAlignOptions
from repro_torch import kernels, obs
from repro_torch.api import Aligner
from repro_torch.core import fmindex as fmx
from repro_torch.data import (decode, make_reference, simulate_pairs,
                              simulate_reads)
from repro_torch.io.stream import _pack_pe, _pack_se
from repro_torch.kernels import engine as cuda_engine
from repro_torch.options import AlignOptions
from repro_torch.serve import AlignmentServer, ServeClient

torch.set_num_threads(1)

CPU = AlignOptions(device="cpu")


def body(al, batch) -> list[str]:
    buf = io.StringIO()
    al.stream_sam([batch], buf, header=False)
    return buf.getvalue().splitlines()


def pick(lines, names) -> list[str]:
    keep = set(names)
    return [ln for ln in lines if ln.split("\t", 1)[0] in keep]


@pytest.fixture(scope="module")
def world():
    """The 30-kbp world of ``tests/test_serve.py`` and each package's
    offline SAM of all its reads and of all its pairs, held equal."""
    ref = make_reference(30000, seed=5)
    idx, ridx = fmx.build_index(ref), rfmx.build_index(ref)
    reads, _ = simulate_reads(ref, 12, 101, seed=3)
    r1, r2, _ = simulate_pairs(ref, 10, 101, insert_mean=300, insert_std=30,
                               seed=9, burst_frac=0.2)
    se = [(f"read{i}", decode(r)) for i, r in enumerate(reads)]
    pe = [(f"pair{i}", decode(a), decode(b))
          for i, (a, b) in enumerate(zip(r1, r2))]
    names = [n for n, _ in se]
    seqs = [s for _, s in se]
    pnames = [n for n, _, _ in pe]
    s1, s2 = [a for _, a, _ in pe], [b for _, _, b in pe]
    ral = RAligner(ridx, RAlignOptions(engine="pallas"))
    want = {"se": body(Aligner(idx, CPU), _pack_se(names, seqs)),
            "pe": body(Aligner(idx, CPU), _pack_pe(pnames, s1, s2))}
    assert want["se"] == body(ral, r_pack_se(names, seqs))
    assert want["pe"] == body(ral, r_pack_pe(pnames, s1, s2))
    return idx, se, pe, want


@pytest.fixture()
def racing(world, monkeypatch):
    """Drop the index's lazy caches so the threads race to rebuild them,
    count the rebuilds, and switch threads often while the test runs."""
    idx = world[0]
    idx._views.clear()
    if hasattr(idx, "_cuda_occ_cfg"):
        del idx._cuda_occ_cfg
    built = {"sweep": 0, "views": 0}
    sweep, arrays = cuda_engine.sweep_occ_configs, fmx.FMArrays

    def counted_sweep(*a, **k):
        built["sweep"] += 1
        return sweep(*a, **k)

    def counted_arrays(*a, **k):
        built["views"] += 1
        return arrays(*a, **k)

    monkeypatch.setattr(cuda_engine, "sweep_occ_configs", counted_sweep)
    monkeypatch.setattr(fmx, "FMArrays", counted_arrays)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    launches = kernels.launch_counts()
    try:
        yield built
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts() == launches


def _merge_counters(snaps):
    total = obs.Snapshot.merge_all(snaps)
    return {k: v for k, v in total.items()
            if isinstance(v, (int, float)) and not k.startswith("time")}


def _run_threads(n, fn) -> list:
    errors: list = []

    def worker(i):
        try:
            fn(i)
        except Exception as e:              # noqa: BLE001 — collected
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_concurrent_clients_identity(world):
    """8 clients hammering SE+PE concurrently, every response offline-
    identical — the acceptance-criteria scenario."""
    idx, se, pe, want = world
    srv = AlignmentServer(idx, CPU)
    srv.start()

    def client(i):
        with ServeClient.connect(*srv.address) as c:
            for _ in range(2):
                if i % 2:
                    sub = se[i % len(se):]
                    assert c.align(sub).sam == pick(want["se"],
                                                    [n for n, _ in sub])
                else:
                    assert c.align_pairs(pe).sam == want["pe"]
    try:
        errors = _run_threads(8, client)
    finally:
        srv.shutdown()
    assert not errors, errors
    assert srv.live_stats().get("serve_requests", 0) == 16


@pytest.mark.parametrize("n", [2, 4])
def test_aligner_thread_safety(world, racing, n):
    """N threads hammering ONE Aligner: every per-call SAM identical to
    the serial run and to the reference's, merged counters equal to the
    serial merge (no lost updates in telemetry), and one occ-layout attach
    and one device view of the index however the threads raced them."""
    idx, se, _, want = world
    al = Aligner(idx, CPU, telemetry=True)
    parts = [se[i * 3:i * 3 + 3] for i in range(n)]
    batches = [_pack_se([m for m, _ in p], [s for _, s in p]) for p in parts]
    sams = [None] * n
    stats = [None] * n

    def worker(i):
        res = al.align(batches[i])
        sams[i] = res.sam()
        stats[i] = res.stats

    assert not _run_threads(n, worker)
    assert racing == {"sweep": 1, "views": 1}
    serial = [al.align(b) for b in batches]
    for i in range(n):
        assert sams[i] == serial[i].sam(), f"thread {i} bytes diverged"
        assert sams[i] == pick(want["se"], [m for m, _ in parts[i]])
    assert _merge_counters(stats) == \
        _merge_counters([r.stats for r in serial])


def test_aligner_pe_thread_safety(world, racing):
    idx, _, pe, want = world
    al = Aligner(idx, CPU, telemetry=True)
    batch = _pack_pe([n for n, _, _ in pe], [a for _, a, _ in pe],
                     [b for _, _, b in pe])
    out = [None] * 3

    def worker(i):
        out[i] = al.align_pairs(batch).sam()

    assert not _run_threads(3, worker)
    assert racing == {"sweep": 1, "views": 1}
    assert all(o == want["pe"] for o in out)
