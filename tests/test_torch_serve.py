"""The port's alignment service (``repro_torch.serve``) on the CPU path,
mirroring ``tests/test_serve.py`` case by case.

The load-bearing assertion throughout: the SAM records streamed back for
one request are byte-identical to an offline ``stream_sam`` over the same
reads and options, of the port (``Aligner(device="cpu")``) and of the
reference (``repro.api.Aligner`` with the ``pallas`` engine, its Pallas
kernels in interpret mode), under arbitrary coalescing (forced
deterministically with ``pause()``/``resume()``), SE and PE, and a
3-contig reference.  Plus the lifecycle edges: zero-read requests,
oversized reads, backpressure, client disconnects mid-batch, deadline
expiry without poisoning the cohort, and drain-on-shutdown.  The
concurrent clients and the ``Aligner`` thread hammers are in
``tests/test_torch_serve_threads.py``; clients and servers across the two
packages and ``cli serve`` in ``tests/test_torch_serve_cli.py``.

Each package's offline SAM is computed once per world, over all of the
world's reads; a request's expected lines are those of its reads (SE
output of a read does not depend on the batch it runs in, nor PE output
of a pair once the insert-size stats are frozen).
"""

from __future__ import annotations

import io
import threading
import time

import pytest
import torch

from repro.api import Aligner as RAligner
from repro.core import fmindex as rfmx
from repro.core.contig import build_contig_index as r_build_contig_index
from repro.io.stream import _pack_pe as r_pack_pe
from repro.io.stream import _pack_se as r_pack_se
from repro.options import AlignOptions as RAlignOptions
from repro_torch import obs
from repro_torch.api import Aligner
from repro_torch.core import fmindex as fmx
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (decode, make_reference, simulate_pairs,
                              simulate_pairs_multi, simulate_reads,
                              simulate_reads_multi, simulate_reference)
from repro_torch.io.stream import _pack_pe, _pack_se
from repro_torch.options import AlignOptions
from repro_torch.serve import (AlignmentServer, Overloaded, QueueClosed,
                               RequestQueue, ServeClient, ServeError,
                               protocol)
from repro_torch.serve.batcher import Request

torch.set_num_threads(1)

CPU = AlignOptions(device="cpu")
RG_FLAGS = {"-T": 25, "-R": "@RG\\tID:svc"}


# ---------------------------------------------------------------------
# Offline runs of both packages
# ---------------------------------------------------------------------

def offline(al, batch, header: bool = True) -> list[str]:
    """One offline ``stream_sam`` run (its header has no @PG)."""
    buf = io.StringIO()
    al.stream_sam([batch], buf, header=header)
    return buf.getvalue().splitlines()


def se_batch(pack, items):
    return pack([n for n, _ in items], [s for _, s in items])


def pe_batch(pack, items):
    return pack([n for n, _, _ in items], [a for _, a, _ in items],
                [b for _, _, b in items])


class Want:
    """Offline SAM of the port and of the reference over one read set:
    ``header()`` and ``body(names)`` return the port's lines after
    checking that the reference's are the same."""

    def __init__(self, port: list[str], ref: list[str]):
        self.port, self.ref = port, ref

    def header(self) -> list[str]:
        got = [ln for ln in self.port if ln.startswith("@")]
        assert got == [ln for ln in self.ref if ln.startswith("@")]
        return got

    def body(self, names) -> list[str]:
        keep = set(names)
        pick = lambda lines: [ln for ln in lines if not ln.startswith("@")
                              and ln.split("\t", 1)[0] in keep]
        got = pick(self.port)
        assert got and got == pick(self.ref)
        return got


def names_of(items) -> list[str]:
    return [it[0] for it in items]


def want_se(tidx, ridx, items, flags=None) -> Want:
    flags = flags or {}
    return Want(
        offline(Aligner(tidx, AlignOptions.from_flags(flags, device="cpu")),
                se_batch(_pack_se, items)),
        offline(RAligner(ridx, RAlignOptions.from_flags(flags,
                                                        engine="pallas")),
                se_batch(r_pack_se, items)))


def want_pe(tidx, ridx, items, stats=None) -> Want:
    tstats, rstats = stats or (None, None)
    return Want(
        offline(Aligner(tidx, CPU, pe_stats=tstats),
                pe_batch(_pack_pe, items)),
        offline(RAligner(ridx, RAlignOptions(engine="pallas"),
                         pe_stats=rstats),
                pe_batch(r_pack_pe, items)))


# ---------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    ref = make_reference(30000, seed=5)
    tidx, ridx = fmx.build_index(ref), rfmx.build_index(ref)
    reads, _ = simulate_reads(ref, 12, 101, seed=3)
    r1, r2, _ = simulate_pairs(ref, 10, 101, insert_mean=300, insert_std=30,
                               seed=9, burst_frac=0.2)
    se = [(f"read{i}", decode(r)) for i, r in enumerate(reads)]
    pe = [(f"pair{i}", decode(a), decode(b))
          for i, (a, b) in enumerate(zip(r1, r2))]
    stats = (Aligner(tidx, CPU).estimate_pe_stats(pe_batch(_pack_pe, pe)),
             RAligner(ridx, RAlignOptions(engine="pallas")).estimate_pe_stats(
                 pe_batch(r_pack_pe, pe)))
    want = {"se": want_se(tidx, ridx, se),
            "se_rg": want_se(tidx, ridx, se, RG_FLAGS),
            "pe": want_pe(tidx, ridx, pe),
            "pe_frozen": want_pe(tidx, ridx, pe, stats)}
    return tidx, se, pe, stats[0], want


@pytest.fixture(scope="module")
def contig_world():
    contigs = simulate_reference(45000, 3, seed=11)
    tidx = build_contig_index(contigs)
    ridx = r_build_contig_index(contigs)
    r1, r2, _ = simulate_pairs_multi(contigs, 8, 101, seed=13,
                                     insert_mean=300, insert_std=30,
                                     burst_frac=0.1)
    reads, _ = simulate_reads_multi(contigs, 8, 101, seed=29)
    se = [(f"mread{i}", decode(r)) for i, r in enumerate(reads)]
    pe = [(f"mpair{i}", decode(a), decode(b))
          for i, (a, b) in enumerate(zip(r1, r2))]
    return tidx, se, pe, {"se": want_se(tidx, ridx, se),
                          "pe": want_pe(tidx, ridx, pe)}


@pytest.fixture()
def server(world):
    srv = AlignmentServer(world[0], CPU)
    srv.start()
    yield srv
    srv.shutdown()


def _wait_queued(srv, n, timeout=5.0):
    """Wait until ``n`` requests reached a PAUSED server's scheduler:
    the scheduler pops the first arrival before blocking on the pause
    gate, so at most one request is held outside the queue."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        accepted = srv.metrics.snapshot().get("serve_requests", 0)
        if accepted >= n and len(srv.queue) >= n - 1:
            time.sleep(0.1)               # let in-flight puts settle
            return
        time.sleep(0.01)
    raise AssertionError(
        f"only {srv.metrics.snapshot().get('serve_requests', 0)}/{n} "
        f"requests accepted ({len(srv.queue)} queued) after {timeout}s")


def _run_paused(srv, parts, call) -> list:
    """Send each part from its own client thread to the paused ``srv``,
    resume once all are queued, and return the results in part order."""
    results = [None] * len(parts)

    def worker(i):
        with ServeClient.connect(*srv.address) as c:
            results[i] = call(c, parts[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(parts))]
    for t in threads:
        t.start()
    _wait_queued(srv, len(parts))
    srv.resume()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results


# ---------------------------------------------------------------------
# Conformance: byte-identity with the offline runs
# ---------------------------------------------------------------------

def test_se_identity_with_header(server, world):
    _, se, _, _, want = world
    res = ServeClient.connect(*server.address).align(se, header=True)
    assert res.header == want["se"].header()
    assert res.sam == want["se"].body(names_of(se))
    assert res.n_records == len(res.sam)


def test_pe_identity(server, world):
    _, _, pe, _, want = world
    res = ServeClient.connect(*server.address).align_pairs(pe)
    assert res.sam == want["pe"].body(names_of(pe))
    assert len(res.sam) == 2 * len(pe)        # emit_pair: 2 lines/pair


def test_per_request_options_and_rg(server, world):
    """Per-request flags land in their own cohort; @RG is request-scoped;
    the cohort stays on the server's device."""
    _, se, _, _, want = world
    res = ServeClient.connect(*server.address).align(
        se, flags=RG_FLAGS, header=True)
    assert res.header == want["se_rg"].header()
    assert res.sam == want["se_rg"].body(names_of(se))
    assert any(ln.startswith("@RG") for ln in res.header)
    assert all("RG:Z:svc" in ln for ln in res.sam)
    assert {o.device for o in server._aligners} == {"cpu"}


def test_se_coalescing_identity(server, world):
    """Force 3 requests into ONE engine batch; each response must equal
    its own offline run (split correctness + composition independence)."""
    idx, se, _, _, want = world
    parts = [se[:5], se[5:8], se[8:]]
    server.pause()
    before = server.metrics.snapshot().get("serve_batches", 0)
    results = _run_paused(server, parts, lambda c, p: c.align(p))
    for part, res in zip(parts, results):
        assert res.sam == want["se"].body(names_of(part))
        assert res.sam == offline(Aligner(idx, CPU),
                                  se_batch(_pack_se, part), header=False)
    after = server.live_stats()
    assert after.get("serve_batches", 0) - before == 1   # ONE batch ran


def test_pe_coalescing_with_frozen_stats(world):
    """PE requests coalesce only with frozen insert-size stats; output
    stays identical to per-request offline runs with the same stats."""
    idx, _, pe, stats, want = world
    srv = AlignmentServer(idx, CPU, pe_stats=stats)
    srv.start()
    try:
        parts = [pe[:4], pe[4:7], pe[7:]]
        srv.pause()
        before = srv.metrics.snapshot().get("serve_batches", 0)
        results = _run_paused(srv, parts, lambda c, p: c.align_pairs(p))
        for part, res in zip(parts, results):
            assert res.sam == want["pe_frozen"].body(names_of(part))
            assert res.sam == offline(Aligner(idx, CPU, pe_stats=stats),
                                      pe_batch(_pack_pe, part), header=False)
        assert srv.live_stats().get("serve_batches", 0) - before == 1
    finally:
        srv.shutdown()


def test_multi_contig_identity(contig_world):
    idx, se, pe, want = contig_world
    srv = AlignmentServer(idx, CPU)
    srv.start()
    try:
        with ServeClient.connect(*srv.address) as c:
            res = c.align(se, header=True)
            assert res.sam == want["se"].body(names_of(se))
            assert res.header == want["se"].header()
            assert sum(ln.startswith("@SQ") for ln in res.header) == 3
            assert c.align_pairs(pe).sam == want["pe"].body(names_of(pe))
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------
# Edge cases
# ---------------------------------------------------------------------

def test_zero_read_request(server, world):
    with ServeClient.connect(*server.address) as c:
        res = c.align([], header=True)
        assert res.sam == [] and res.n_records == 0
        assert res.header == world[4]["se"].header()
        assert c.align_pairs([]).n_records == 0
        assert c.ping()["engine"] == "cuda"


def test_oversized_read_rejected(world):
    idx, se, _, _, want = world
    srv = AlignmentServer(idx, CPU, max_read_len=150)
    srv.start()
    try:
        with ServeClient.connect(*srv.address) as c:
            with pytest.raises(ServeError) as ei:
                c.align([("big", "A" * 151)])
            assert ei.value.code == protocol.ERR_READ_TOO_LONG
            with pytest.raises(ServeError) as ei:
                c.align_pairs([("p", "ACGT", "A" * 400)])
            assert ei.value.code == protocol.ERR_READ_TOO_LONG
            # the connection survives a rejected request
            assert c.align(se[:2]).sam == want["se"].body(names_of(se[:2]))
    finally:
        srv.shutdown()


def test_bad_requests_are_structured(server):
    with ServeClient.connect(*server.address) as c:
        for req in ({"op": "align"},                      # no reads
                    {"op": "align", "reads": [["x"]]},    # arity
                    {"op": "align", "reads": [["x", ""]]},  # empty seq
                    {"op": "align", "reads": [["x", "ACGT"]],
                     "flags": {"-Z": 1}},                 # unknown flag
                    {"op": "align", "reads": [["x", "ACGT"]],
                     "flags": {"device": "cuda"}},        # not a bwa flag
                    {"op": "nope"}):
            protocol.send_frame(c._sock, req)
            frame = protocol.recv_frame(c._sock)
            assert frame["type"] == "error"
            assert frame["code"] == protocol.ERR_BAD_REQUEST


def test_backpressure_overloaded(world):
    idx, se, _, _, _ = world
    srv = AlignmentServer(idx, CPU, max_queue=2)
    srv.start()
    try:
        srv.pause()
        clients, ok, rejected = [], [], []
        for i in range(6):
            c = ServeClient.connect(*srv.address)
            clients.append(c)
            protocol.send_frame(c._sock, {"op": "align", "id": f"q{i}",
                                          "reads": [["r", se[0][1]]]})
        deadline = time.time() + 5
        while (srv.metrics.snapshot().get("serve_requests", 0) < 6 and
               time.time() < deadline):
            time.sleep(0.01)
        srv.resume()
        for c in clients:
            try:
                frames = []
                while True:
                    f = protocol.recv_frame(c._sock)
                    frames.append(f)
                    if f["type"] in ("end", "error"):
                        break
                (rejected if frames[-1]["type"] == "error" else ok).append(
                    frames[-1])
            finally:
                c.close()
        assert all(f["code"] == protocol.ERR_OVERLOADED for f in rejected)
        assert len(ok) >= 2 and len(rejected) >= 1
        assert len(ok) + len(rejected) == 6
    finally:
        srv.shutdown()


def test_client_disconnect_mid_batch(server, world):
    """A client that vanishes before its response is sent must not poison
    the coalesced batch: the surviving request still gets exact bytes."""
    _, se, _, _, want = world
    server.pause()
    ghost = ServeClient.connect(*server.address)
    protocol.send_frame(ghost._sock, {"op": "align", "id": "ghost",
                                      "reads": [["g", se[0][1]]]})
    _wait_queued(server, 1)
    result = {}

    def worker():
        with ServeClient.connect(*server.address) as c:
            result["sam"] = c.align(se[2:6]).sam

    t = threading.Thread(target=worker)
    t.start()
    _wait_queued(server, 2)
    ghost.close()                              # vanish before scheduling
    time.sleep(0.1)
    server.resume()
    t.join(timeout=30)
    assert not t.is_alive()
    assert result["sam"] == want["se"].body(names_of(se[2:6]))


def test_deadline_does_not_poison_cohort(server, world):
    """An expired request gets a structured deadline error; a same-cohort
    request in the SAME batch still succeeds with exact bytes."""
    _, se, _, _, want = world
    server.pause()
    outcome = {}

    def doomed():
        with ServeClient.connect(*server.address) as c:
            try:
                c.align(se[:3], deadline_s=0.05)
                outcome["doomed"] = "ok"
            except ServeError as e:
                outcome["doomed"] = e.code

    def survivor():
        with ServeClient.connect(*server.address) as c:
            outcome["sam"] = c.align(se[3:6]).sam

    t1 = threading.Thread(target=doomed)
    t2 = threading.Thread(target=survivor)
    t1.start()
    t2.start()
    _wait_queued(server, 2)
    time.sleep(0.2)                            # let the 0.05s deadline pass
    server.resume()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not t1.is_alive() and not t2.is_alive()
    assert outcome["doomed"] == protocol.ERR_DEADLINE
    assert outcome["sam"] == want["se"].body(names_of(se[3:6]))
    assert server.live_stats().get("serve_timeouts", 0) >= 1


def test_shutdown_drains_queue(world):
    idx, se, _, _, want = world
    srv = AlignmentServer(idx, CPU)
    srv.start()
    srv.pause()
    results = [None] * 3

    def worker(i):
        with ServeClient.connect(*srv.address) as c:
            results[i] = c.align(se[i * 4:(i + 1) * 4])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    _wait_queued(srv, 3)
    srv.shutdown(drain=True)                  # resumes + drains + stops
    for t in threads:
        t.join(timeout=30)
    for i in range(3):
        part = se[i * 4:(i + 1) * 4]
        assert results[i].sam == want["se"].body(names_of(part))


def test_rejects_after_shutdown(world):
    idx, se, _, _, _ = world
    srv = AlignmentServer(idx, CPU)
    srv.start()
    c = ServeClient.connect(*srv.address)
    srv.shutdown()
    with pytest.raises((ServeError, ConnectionError, OSError)):
        res = c.align(se[:1])
        raise AssertionError(f"unexpected success: {res}")
    c.close()


# ---------------------------------------------------------------------
# Queue mechanics (no sockets)
# ---------------------------------------------------------------------

def _req(i, op="align", options=None, n=1):
    return Request(id=f"q{i}", op=op, names=[f"r{j}" for j in range(n)],
                   seqs=(["ACGT"] * n if op == "align"
                         else [("ACGT", "ACGT")] * n),
                   options=options or AlignOptions(), engine=None,
                   header=False, deadline=None, conn=None)


def test_queue_cohorts_and_budget():
    q = RequestQueue(maxsize=8)
    strict = AlignOptions(min_score=40)
    for i in range(3):
        q.put(_req(i, n=2))
    q.put(_req(3, options=strict, n=2))
    q.put(_req(4, op="align_pairs", n=1))
    first = q.get()
    key = first.cohort_key(False)
    taken = q.take_cohort(key, False, budget_reads=2)
    assert [r.id for r in taken] == ["q1"]     # budget stops at 2 reads
    taken = q.take_cohort(key, False, budget_reads=99)
    assert [r.id for r in taken] == ["q2"]     # q3/q4 are other cohorts
    assert len(q) == 2                         # order preserved for them
    assert q.get().id == "q3"
    # PE requests never share a cohort without frozen stats
    pe1, pe2 = _req(8, op="align_pairs"), _req(9, op="align_pairs")
    assert pe1.cohort_key(False) != pe2.cohort_key(False)
    assert pe1.cohort_key(True) == pe2.cohort_key(True)
    # a request on another device is another cohort
    assert _req(5).cohort_key(False) != \
        _req(6, options=CPU).cohort_key(False)


def test_queue_overload_and_close():
    q = RequestQueue(maxsize=1)
    q.put(_req(0))
    with pytest.raises(Overloaded):
        q.put(_req(1))
    q.close()
    assert q.get().id == "q0"                  # drains after close
    with pytest.raises(QueueClosed):
        q.get()


# ---------------------------------------------------------------------
# Observability wiring
# ---------------------------------------------------------------------

def test_runlog_and_live_export(tmp_path, world):
    idx, se, pe, _, want = world
    runlog = obs.RunLog(tmp_path / "serve.runlog.jsonl")
    runlog.manifest("test serve", engine="cuda")
    exporter = obs.LiveExporter(str(tmp_path / "serve.live"), interval=0.05)
    srv = AlignmentServer(idx, CPU, runlog=runlog, exporter=exporter)
    srv.start()
    with ServeClient.connect(*srv.address) as c:
        assert c.align(se).sam == want["se"].body(names_of(se))
        assert c.align_pairs(pe).sam == want["pe"].body(names_of(pe))
    srv.shutdown()
    events = obs.read_runlog(tmp_path / "serve.runlog.jsonl")
    kinds = [e["event"] for e in events]
    assert "serve_start" in kinds and "serve_stop" in kinds
    assert kinds.count("request") == 2
    assert kinds.count("batch_coalesced") == 2
    assert kinds.count("request_done") == 2
    assert "crash" not in kinds and "request_error" not in kinds
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["engine"] == "cuda" and srv.options.device == "cpu"
    reqs = [e for e in events if e["event"] == "batch_coalesced"]
    assert {e["op"] for e in reqs} == {"align", "align_pairs"}
    prom = (tmp_path / "serve.live.prom").read_text()
    assert "serve_requests" in prom and "serve_batches" in prom
    for ln in prom.splitlines():               # textfile format parses
        assert not ln or ln.startswith("#") or len(ln.split()) >= 2
