"""The port's own trace: SMEM's round spans and live-entry counters, the
``chunk`` span and the chunk index every span of a chunk carries, the
device track timed by CUDA events and resolved on the host clock, and the
clock pairs that put the trace on the profiler's Unix clock.

CPU tests run ``Aligner.stream_sam`` on a tiny genome, and the event
arithmetic on fake events.  ``test_device_times_match_the_profiler`` is
marked ``card``: it needs a CUDA device and skips without one (run it on
the card with ``python -m pytest -m card -s tests/test_torch_obs_trace.py``).
This file imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import Aligner
from repro_torch.core import fmindex as fmx
from repro_torch.core import smem as smem_mod
from repro_torch.data import (make_reference, simulate_reads,
                              write_fastq)
from repro_torch.io.stream import open_batches
from repro_torch.obs import trace as trace_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMEM_PARTS = ("smem.pack", "smem.round", "smem.unpack", "smem.sweep")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref = make_reference(20000, seed=11)
    idx = fmx.build_index(ref)
    reads, _ = simulate_reads(ref, 14, 101, seed=5)
    fq = str(tmp_path_factory.mktemp("torch_obs_trace") / "reads.fq")
    write_fastq(fq, reads)
    return idx, reads, fq


def traced_run(idx, fq, out, **kw):
    tele = obs.Telemetry(trace=True)
    al = Aligner.from_index(idx, device="cpu", telemetry=tele)
    summary = al.stream_sam(open_batches(fq, batch_size=8), str(out), **kw)
    return tele.tracer, summary


def inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_smem_round_spans_nest_and_count_live_entries(world, tmp_path,
                                                      monkeypatch):
    idx, _, fq = world
    sent = []
    ext_round = smem_mod.ext_round

    def counting(fm, which, k, *a, **kw):
        sent.append(k.numel())
        return ext_round(fm, which, k, *a, **kw)

    monkeypatch.setattr(smem_mod, "ext_round", counting)
    tracer, summary = traced_run(idx, fq, tmp_path / "t.sam")
    st = summary["stats"]
    events = tracer.to_dict()["traceEvents"]
    smem = [e for e in events if e["name"] == "smem"]
    parts = [e for e in events if e["name"] in SMEM_PARTS]
    assert smem and {e["name"] for e in parts} == set(SMEM_PARTS)
    assert all(any(inside(p, s) for s in smem) for p in parts)
    for name in SMEM_PARTS:
        assert st[f"time_{name}_s"] > 0
    assert sum(st[f"time_{n}_s"] for n in SMEM_PARTS) <= st["time_smem_s"]
    # every round counts its live entries and its dense slots once
    assert 0 < st["smem_live_entries"] <= st["smem_round_slots"]
    assert st["smem_live_entries"] == sum(sent)
    assert st["smem_rounds"] >= len(sent)
    assert st["smem_h2d_bytes"] == 16 * sum(sent)


def test_every_span_of_a_chunk_carries_its_index(world, tmp_path):
    idx, _, fq = world
    rl = obs.RunLog(tmp_path / "run.jsonl")
    tracer, summary = traced_run(idx, fq, tmp_path / "t.sam", runlog=rl)
    rl.close()
    batches = [e["i"] for e in obs.read_runlog(rl.path)
               if e["event"] == "batch"]
    events = [e for e in tracer.to_dict()["traceEvents"] if e["ph"] == "X"]
    chunks = [e for e in events if e["name"] == "chunk"]
    assert [c["args"]["chunk"] for c in chunks] == batches == [0, 1]
    assert summary["stats"]["time_chunk_s"] > 0
    for e in events:
        owner = [c for c in chunks if inside(e, c)]
        if owner:
            assert e["args"]["chunk"] == owner[0]["args"]["chunk"], e
        else:
            assert "chunk" not in e.get("args", {}), e
    # the facade's stages run inside the chunk span
    named = {e["name"] for e in events if "chunk" in e.get("args", {})}
    assert {"smem", "sal", "chain", "bsw", "finalize", "sam_format",
            *SMEM_PARTS} <= named


def test_sam_is_the_same_with_telemetry_on_and_off(world, tmp_path):
    idx, _, fq = world
    traced_run(idx, fq, tmp_path / "on.sam")
    Aligner.from_index(idx, device="cpu").stream_sam(
        open_batches(fq, batch_size=8), str(tmp_path / "off.sam"))
    on = (tmp_path / "on.sam").read_bytes()
    assert on == (tmp_path / "off.sam").read_bytes() and on.count(b"\n") > 14


def test_telemetry_off_records_nothing(world, tmp_path, monkeypatch):
    idx, _, fq = world
    calls = []

    def refuse(name):
        def f(*a, **kw):
            calls.append(name)
            raise AssertionError(f"{name} with telemetry off")
        return f

    monkeypatch.setattr(trace_mod._Span, "__init__", refuse("span"))
    monkeypatch.setattr(trace_mod._DeviceSpan, "__init__",
                        refuse("device span"))
    monkeypatch.setattr(obs.MetricsRegistry, "inc", refuse("counter"))
    monkeypatch.setattr(obs.MetricsRegistry, "observe", refuse("histogram"))
    monkeypatch.setattr(obs.TraceCollector, "take_event", refuse("event"))
    summary = Aligner.from_index(idx, device="cpu").stream_sam(
        open_batches(fq, batch_size=8), str(tmp_path / "off.sam"))
    assert calls == []
    assert summary["n_batches"] == 2
    assert not any(k.startswith("time_") or k.startswith("smem_live")
                   for k in summary["stats"])


# ---------------------------------------------------------------------
# The device track, on fake events
# ---------------------------------------------------------------------

class FakeDevice:
    """A device clock, in seconds, that the test moves by hand."""
    now = 0.0


class FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream):
        self.t = FakeDevice.now

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class FakeStream:
    class device:
        index = 0

    def __eq__(self, other):
        return isinstance(other, FakeStream)

    def __hash__(self):
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    FakeEvent.made = 0
    FakeDevice.now = 5.0


def launch(kernel: str, seconds: float):
    with obs.device_span(kernel, "cuda"):
        FakeDevice.now += seconds


def test_device_events_resolve_on_the_host_clock(fake_cuda):
    tracer = obs.TraceCollector()
    with obs.activate(obs.MetricsRegistry(), tracer):
        with obs.chunk(3):
            with obs.activate(obs.MetricsRegistry(), tracer) as reg:
                launch("bsw", 0.004)
                FakeDevice.now += 0.001       # a gap on the device
                launch("galign", 0.002)
                assert tracer.device_events == []   # not resolved yet
            snap = reg.snapshot()
        with obs.activate(obs.MetricsRegistry(), tracer) as reg2:
            launch("bsw", 0.003)
    assert snap["time_device_bsw_s"] == pytest.approx(0.004)
    assert snap["time_device_galign_s"] == pytest.approx(0.002)
    assert reg2.snapshot()["time_device_bsw_s"] == pytest.approx(0.003)
    # one resolve a scope, each with its clock pair; the events of the
    # first scope end where its anchor was stamped, less the distance
    assert len(tracer.clock_pairs) == 3
    bsw, galign, bsw2 = tracer.device_events
    anchor_us = (tracer.clock_pairs[1][0] - tracer._epoch) * 1e6
    assert galign["ts"] + galign["dur"] == pytest.approx(anchor_us)
    assert galign["ts"] - (bsw["ts"] + bsw["dur"]) == pytest.approx(1e3)
    assert (bsw["dur"], galign["dur"], bsw2["dur"]) == pytest.approx(
        (4e3, 2e3, 3e3))
    assert bsw["args"] == galign["args"] == {"chunk": 3}
    assert "args" not in bsw2
    assert {e["tid"] for e in tracer.device_events} == {trace_mod.DEVICE_TID}
    # the pool: two launches and an anchor, then the same three again
    assert FakeEvent.made == 5


class FakeGate:
    def __init__(self, log):
        self.log = log

    def hold(self, stream):
        self.log.append("hold")
        return 7

    def release(self, token):
        self.log.append(("release", token))


def test_the_gate_holds_the_stream_around_the_launch(fake_cuda,
                                                      monkeypatch):
    log = []
    record = FakeEvent.record
    monkeypatch.setattr(FakeEvent, "record", lambda self, stream: (
        log.append("record"), record(self, stream)))
    tracer, gate = obs.TraceCollector(), FakeGate(log)
    with obs.activate(obs.MetricsRegistry(), tracer) as reg:
        with obs.device_span("bsw", "cuda", gate):
            log.append("launch")
        with pytest.raises(RuntimeError, match="bad launch"):
            with obs.device_span("bsw", "cuda", gate):
                raise RuntimeError("bad launch")
    # start event, launch, end event inside the hold; a failed launch is
    # released too and leaves no pending pair; then the anchor
    assert log == ["hold", "record", "launch", "record", ("release", 7),
                   "hold", "record", ("release", 7), "record"]
    assert len(tracer.device_events) == 1
    assert "time_device_bsw_s" in reg.snapshot()


def test_device_span_is_off_without_a_tracer(fake_cuda):
    assert obs.device_span("bsw", "cuda") is obs.NULL_SPAN
    with obs.activate(obs.MetricsRegistry()) as reg:
        assert obs.device_span("bsw", "cuda") is obs.NULL_SPAN
        launch("bsw", 0.001)
    assert FakeEvent.made == 0 and "time_device_bsw_s" not in reg.snapshot()


def test_host_spans_leave_out_the_device_track(fake_cuda, tmp_path):
    from bench.trace import host_spans
    tracer = obs.TraceCollector()
    with obs.activate(obs.MetricsRegistry(), tracer):
        with obs.span("smem"):
            launch("fmocc", 0.001)
    # the resolve is a host span of its own, the kernel is not
    assert [s[0] for s in host_spans(tracer)] == ["smem", "obs.resolve"]
    assert len(tracer) == 3
    path = tmp_path / "t.json"
    tracer.save(path)
    saved = json.loads(path.read_text())
    dev = [e for e in saved["traceEvents"] if e.get("cat") == "device"]
    assert [e["name"] for e in dev] == ["fmocc"]
    meta = [e for e in saved["traceEvents"] if e["ph"] == "M"]
    assert meta == [{"name": "thread_name", "ph": "M", "pid": dev[0]["pid"],
                     "tid": dev[0]["tid"], "args": {"name": "cuda:0"}}]
    other = saved["otherData"]
    assert other["epoch_perf_s"] == tracer._epoch
    pairs = other["clock_pairs"]
    assert len(pairs) == 2 and all(
        isinstance(t, float) and isinstance(ns, int) for t, ns in pairs)
    assert pairs[0][0] <= pairs[1][0] and pairs[0][1] <= pairs[1][1]


def test_saved_trace_of_a_run_holds_the_clock_pairs(world, tmp_path):
    idx, _, fq = world
    tracer, _ = traced_run(idx, fq, tmp_path / "t.sam")
    tracer.save(tmp_path / "t.json")
    saved = json.loads((tmp_path / "t.json").read_text())
    # a CPU run launches no kernel: no device track, one pair (creation)
    assert len(saved["otherData"]["clock_pairs"]) == 1
    assert not any(e.get("cat") == "device" for e in saved["traceEvents"])


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")


def _profiler_kernels(prof, sub: str) -> list[tuple[int, int]]:
    """(start ns, duration ns) of the profiler's device events whose
    name holds ``sub``, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                sub in e.name():
            out.append((int(e.start_ns()), int(e.duration_ns())))
    return sorted(out)


def _to_unix_ns(tracer, ts_us: float) -> float:
    """A device event's ``ts`` on the Unix clock, through the first clock
    pair stamped after it: its own resolve's, whose anchor placed it."""
    t = tracer._epoch + ts_us / 1e6
    t0, ns0 = next((p for p in tracer.clock_pairs if p[0] >= t),
                   tracer.clock_pairs[-1])
    return ns0 + (t - t0) * 1e9


@pytest.mark.card
def test_device_times_match_the_profiler(card, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    ref = make_reference(400_000, seed=3)
    idx = fmx.build_index(ref)
    reads, _ = simulate_reads(ref, 8192, 151, seed=9, snp_rate=0.02)
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, reads)
    tele = obs.Telemetry(trace=True)
    al = Aligner.from_index(idx, device=card, telemetry=tele)
    al.align(reads[:512])                       # builds, sweeps, warms
    torch.cuda.synchronize(card)
    tele.tracer = obs.TraceCollector()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = al.stream_sam(open_batches(fq, batch_size=2048),
                                str(tmp_path / "o.sam"))
        torch.cuda.synchronize(card)
    st = summary["stats"]
    ratio, launches = {}, {}
    for kernel, sub in (("bsw", "bsw_kernel"), ("galign", "galign"),
                        ("fmocc", "ext_round_kernel")):
        found = _profiler_kernels(prof, sub)
        prof_s = sum(d for _, d in found) / 1e9
        ratio[kernel] = st[f"time_device_{kernel}_s"] / prof_s
        launches[kernel] = (len(found), 1e6 * prof_s / max(len(found), 1))
    tracer = tele.tracer
    ours = sorted(e["ts"] for e in tracer.device_events
                  if e["name"] == "bsw")
    theirs = _profiler_kernels(prof, "bsw_kernel")
    assert len(ours) == len(theirs) > 0
    off_ms = [(_to_unix_ns(tracer, ts) - s) / 1e6
              for ts, (s, _) in zip(ours, theirs)]
    print(f"[obs_trace] events/profiler: "
          + " ".join(f"{k} {v:.4f}" for k, v in ratio.items())
          + f"; bsw launches {len(ours)}, start offset ms min "
          f"{min(off_ms):.4f} median {float(np.median(off_ms)):.4f} max "
          f"{max(off_ms):.4f}; clock pairs {len(tracer.clock_pairs)}; "
          f"profiler kernels (count, mean us) {launches}")
    assert 0.9 <= ratio["bsw"] <= 1.1
    assert 0.9 <= ratio["galign"] <= 1.1
    assert max(abs(o) for o in off_ms) < 0.1
