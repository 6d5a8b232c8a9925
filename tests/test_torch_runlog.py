"""Run-scoped observability of the port (``repro_torch.obs.runlog``,
``obs.export``, ``Aligner.stream_sam(runlog=, export=)``, ``dist.api.
align_shard``, ``cli report``), mirroring ``tests/test_runlog.py`` and
the stream/shard cases of ``tests/test_obs.py``, and held against the
reference:

* run-log events equal the reference's once the fields that name the
  run, the host, the clock or the package are dropped (see
  ``normalized``);
* ``prometheus_text`` renders the same text from the same snapshot;
* both CLIs merge one profile of each package into the same merged
  profile, apart from the counters section, whose list differs by design;
* ``stream_sam``'s SAM is byte-identical with the run log and the live
  exporter on and off.
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro import cli as rcli
from repro import obs as robs
from repro.obs.metrics import Snapshot as RSnapshot
from repro_torch import obs
from repro_torch.api import Aligner, AlignOptions
from repro_torch.cli import main as cli_main
from repro_torch.core import fmindex as fmx
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (make_reference, simulate_reads, write_fasta,
                              write_fastq)
from repro_torch.dist.api import align_shard
from repro_torch.ft import StragglerMonitor
from repro_torch.io.stream import open_batches
from repro_torch.obs.metrics import Gauge, Hist, MultiValue, Snapshot

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref = make_reference(20000, seed=7)
    idx = fmx.build_index(ref)
    reads, _ = simulate_reads(ref, 14, 101, seed=3)
    d = tmp_path_factory.mktemp("torch_runlog")
    fq, fa = str(d / "reads.fq"), str(d / "ref.fa")
    write_fastq(fq, reads)
    write_fasta(fa, [("chrT", ref)])
    assert cli_main(["index", fa]) == 0
    return idx, reads, fq, fa


def cpu_aligner(idx, **kw) -> Aligner:
    return Aligner.from_index(idx, device="cpu", **kw)


#: fields that name the run, the host or the package, or read a clock
VOLATILE = {"run", "ts", "t", "pid", "host", "python", "tool", "engine",
            "argv", "batch_s", "reads_per_s", "eta_s", "wall_s", "out"}
#: option fields the two packages name differently (device vs Pallas
#: mode), and the reference's BSW block width (the port sends each wave of
#: extension tasks in one launch and has no such option)
PACKAGE_OPTIONS = {"engine", "device", "kernel_interpret", "bsw_block"}


def normalized(events: list[dict]) -> list[dict]:
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in VOLATILE}
        if e.get("options") is not None:
            e["options"] = {k: v for k, v in e["options"].items()
                            if k not in PACKAGE_OPTIONS}
        out.append(e)
    return out


# ---------------------------------------------------------------------
# RunLog core: envelope schema, validation, lifecycle
# ---------------------------------------------------------------------

def test_runlog_roundtrip_and_envelope(tmp_path):
    p = tmp_path / "run.jsonl"
    with obs.RunLog(p) as rl:
        rl.manifest("test-tool", argv=["--x", "1"], engine="cuda",
                    options=AlignOptions(device="cpu"), extra="hi")
        rl.batch(0, reads=8, records=9, batch_s=0.25, reads_total=8,
                 records_total=9, elapsed_s=0.5, total_reads=16)
        rl.end(status="ok", n_reads=8)
    events = obs.read_runlog(p)
    assert [e["event"] for e in events] == ["run_start", "batch", "run_end"]
    assert {e["run"] for e in events} == {rl.run_id}
    assert [e["seq"] for e in events] == [0, 1, 2]
    for e in events:
        assert e["v"] == obs.RUNLOG_VERSION == robs.RUNLOG_VERSION
        assert isinstance(e["t"], float) and isinstance(e["ts"], float)
    man = events[0]
    assert man["tool"] == "test-tool" and man["argv"] == ["--x", "1"]
    assert man["options"]["engine"] == "cuda" and man["extra"] == "hi"
    assert man["options"]["device"] == "cpu"
    b = events[1]
    assert b["reads_per_s"] == 8 / 0.5
    assert b["eta_s"] == 8 / 16.0
    assert events[2]["status"] == "ok"
    # the reference's reader accepts the port's file, event for event
    assert robs.read_runlog(p) == events


def test_runlog_rejects_malformed_files(tmp_path):
    good = {"v": obs.RUNLOG_VERSION, "run": "r1", "seq": 0, "t": 0.0,
            "ts": 0.0, "event": "run_start"}

    def write(name, lines):
        p = tmp_path / name
        p.write_text("\n".join(lines) + "\n")
        return p

    with pytest.raises(ValueError, match=r"\.jsonl:2: bad JSONL"):
        obs.read_runlog(write("garbage.jsonl",
                              [json.dumps(good), "{not json"]))
    with pytest.raises(ValueError, match="missing 'seq'"):
        obs.read_runlog(write("noseq.jsonl", [json.dumps(
            {k: v for k, v in good.items() if k != "seq"})]))
    with pytest.raises(ValueError, match="version"):
        obs.read_runlog(write("badv.jsonl",
                              [json.dumps(dict(good, v=99))]))
    with pytest.raises(ValueError, match="mixed run ids"):
        obs.read_runlog(write("mixed.jsonl", [
            json.dumps(good), json.dumps(dict(good, run="r2", seq=1))]))
    with pytest.raises(ValueError, match="seq not increasing"):
        obs.read_runlog(write("dupseq.jsonl", [
            json.dumps(good), json.dumps(dict(good, event="x"))]))


def test_runlog_emit_after_close_is_noop(tmp_path):
    rl = obs.RunLog(tmp_path / "r.jsonl")
    assert rl.emit("run_start") is not None
    rl.close()
    assert rl.closed and rl.emit("run_end") is None
    assert len(obs.read_runlog(rl.path)) == 1


def test_run_ids_unique_and_index_fingerprint(world):
    idx = world[0]
    assert obs.new_run_id() != obs.new_run_id()
    assert obs.index_fingerprint(idx) == {"N": int(idx.N)}
    contigs = {"chr1": make_reference(500, seed=1),
               "chr2": make_reference(300, seed=2)}
    cidx = build_contig_index(contigs)
    fp = obs.index_fingerprint(cidx)
    assert fp["N"] == int(cidx.N) and fp["n_contigs"] == 2
    assert len(fp["contigs_sha1"]) == 12
    assert fp["contigs"] == ["chr1", "chr2"]
    assert fp == obs.index_fingerprint(cidx)
    other = build_contig_index({"chr1": make_reference(501, seed=1)})
    assert obs.index_fingerprint(other)["contigs_sha1"] != fp["contigs_sha1"]
    # the reference fingerprints the port's index the same way
    assert robs.index_fingerprint(cidx) == fp


def test_capture_warnings_structured_and_forwarded(tmp_path):
    seen = []
    with obs.RunLog(tmp_path / "w.jsonl") as rl:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = (
                lambda m, c, f, ln, *a: seen.append(str(m)))
            with rl.capture_warnings():
                warnings.warn("rank fallback", RuntimeWarning)
    evs = [e for e in obs.read_runlog(rl.path) if e["event"] == "warning"]
    assert len(evs) == 1
    assert evs[0]["message"] == "rank fallback"
    assert evs[0]["category"] == "RuntimeWarning"
    assert ":" in evs[0]["where"]
    assert seen == ["rank fallback"]
    with obs.RunLog(tmp_path / "e.jsonl") as rl2:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with rl2.capture_warnings():
                with pytest.raises(RuntimeWarning):
                    warnings.warn("boom", RuntimeWarning)


def test_runlog_helpers_equal_reference(tmp_path):
    """The same calls on both packages' RunLog write the same events,
    once the run id, the clocks and the host are dropped."""
    try:
        raise RuntimeError("disk on fire")
    except RuntimeError as e:
        exc = e
    paths = {}
    for name, pkg in (("port", obs), ("reference", robs)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with pkg.RunLog(paths[name]) as rl:
            rl.manifest("tool", argv=["mem", "x"], engine="e",
                        options={"k": 19, "w": 100}, index={"N": 5},
                        shard="0/1")
            rl.batch(0, reads=8, records=9, batch_s=0.25, reads_total=8,
                     records_total=9, elapsed_s=0.5, total_reads=16)
            rl.warning("careful", "RuntimeWarning", "f.py", 3)
            rl.crash(exc, snapshot={"sa_lookups": 4}, batch={"i": 0},
                     trace_tail=[{"name": f"s{i}"} for i in range(40)])
            rl.end(status="error")
    got = obs.read_runlog(paths["port"])
    want = robs.read_runlog(paths["reference"])
    drop = {"run", "ts", "t", "pid", "host"}
    assert [{k: v for k, v in e.items() if k not in drop} for e in got] == \
        [{k: v for k, v in e.items() if k not in drop} for e in want]
    assert len(got[3]["trace_tail"]) == 32


def test_cli_mem_runlog_events_equal_reference(world, tmp_path):
    """``mem --runlog`` of both CLIs on the same reads: the same events
    (manifest, one ``batch`` per batch, stream and run brackets) with
    the same counts, and the same SAM."""
    _, _, fq, fa = world
    common = ["mem", fa, fq, "-b", "8", "--no-pg", "--shard", "0/1"]
    rl_t, rl_r = tmp_path / "t.jsonl", tmp_path / "r.jsonl"
    assert cli_main([*common, "--device", "cpu", "--runlog", str(rl_t),
                     "-o", str(tmp_path / "t.sam")]) == 0
    assert rcli.main([*common, "--engine", "pallas", "--runlog", str(rl_r),
                      "-o", str(tmp_path / "r.sam")]) == 0
    assert (tmp_path / "t.sam").read_text() == \
        (tmp_path / "r.sam").read_text()
    got, want = obs.read_runlog(rl_t), robs.read_runlog(rl_r)
    assert got[0]["tool"] == "repro_torch.cli mem"
    assert got[0]["engine"] == "cuda" and got[0]["options"]["device"] == "cpu"
    assert [e["event"] for e in got] == [
        "run_start", "stream_start", "batch", "batch", "stream_end",
        "run_end"]
    assert normalized(got) == normalized(want)


# ---------------------------------------------------------------------
# stream_sam wiring: events, byte-identity, crash bundle
# ---------------------------------------------------------------------

def test_stream_sam_runlog_events_and_sam_identity(tmp_path, world):
    idx, reads, fq, _ = world
    al = cpu_aligner(idx, telemetry=True)
    out_log = tmp_path / "log.sam"
    rl = obs.RunLog(tmp_path / "run.jsonl")
    exp = obs.LiveExporter(tmp_path / "live", interval=0.01)
    summary = al.stream_sam(open_batches(fq, batch_size=8), str(out_log),
                            runlog=rl, export=exp, total_reads=len(reads))
    rl.close()
    out_plain = tmp_path / "plain.sam"
    cpu_aligner(idx).stream_sam(open_batches(fq, batch_size=8),
                                str(out_plain))
    assert out_log.read_text() == out_plain.read_text()
    events = obs.read_runlog(rl.path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "stream_start" and kinds[-1] == "stream_end"
    assert events[0]["engine"] == "cuda"
    batches = [e for e in events if e["event"] == "batch"]
    assert len(batches) == summary["n_batches"] == 2
    assert batches[-1]["reads_total"] == len(reads)
    assert batches[-1]["reads_per_s"] > 0
    assert batches[0]["eta_s"] is not None
    end = events[-1]
    assert end["n_reads"] == len(reads) and end["reads_per_s"] > 0
    # the exporter's last flush holds the whole run's stats
    final = json.loads(open(exp.json_path).read())
    snap = Snapshot.from_jsonable(final["snapshot"])
    assert snap["io_reads"] == len(reads) == summary["stats"]["io_reads"]
    assert snap["sa_lookups"] == summary["stats"]["sa_lookups"]
    assert exp.last_error is None and exp.n_flushes >= 2


def test_stream_sam_crash_bundle(tmp_path, world):
    idx, _, fq, _ = world
    al = cpu_aligner(idx, telemetry=obs.Telemetry(trace=True))

    def dying_batches():
        it = iter(open_batches(fq, batch_size=8))
        yield next(it)
        raise RuntimeError("disk on fire")

    rl = obs.RunLog(tmp_path / "crash.jsonl")
    with pytest.raises(RuntimeError, match="disk on fire"):
        al.stream_sam(dying_batches(), str(tmp_path / "x.sam"), runlog=rl)
    rl.end(status="error")
    rl.close()
    events = obs.read_runlog(rl.path)
    crashes = [e for e in events if e["event"] == "crash"]
    assert len(crashes) == 1
    c = crashes[0]
    assert c["exc_type"] == "RuntimeError" and "disk on fire" in c["message"]
    assert "dying_batches" in c["traceback"]
    snap = Snapshot.from_jsonable(c["snapshot"])
    assert snap["sa_lookups"] > 0
    assert c["batch"]["i"] == 0 and c["batch"]["size"] == 8
    assert c["batch"]["first_name"].startswith("read")
    assert c["trace_tail"] and all("name" in e for e in c["trace_tail"])
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "error"


def test_stream_sam_counts_io(tmp_path, world):
    idx, reads, fq, _ = world
    al = cpu_aligner(idx, telemetry=True)
    out = tmp_path / "o.sam"
    summary = al.stream_sam(open_batches(fq, batch_size=8), str(out))
    assert summary["n_reads"] == len(reads)
    st = summary["stats"]
    assert st["io_batches"] == 2 and st["io_reads"] == len(reads)
    assert st["time_io_s"] > 0.0
    assert isinstance(st["io_pad_frac"], Hist)
    assert st["io_pad_frac"].count == 2
    out2 = tmp_path / "o2.sam"
    cpu_aligner(idx).stream_sam(open_batches(fq, batch_size=8), str(out2))
    assert out.read_text() == out2.read_text()


# ---------------------------------------------------------------------
# cross-shard merge: counter identity + straggler table
# ---------------------------------------------------------------------

def test_shard_merge_counter_identity(tmp_path, world):
    idx, reads, fq, _ = world
    al = cpu_aligner(idx, telemetry=True)
    full = al.stream_sam(open_batches(fq, batch_size=8),
                         str(tmp_path / "full.sam"))
    rl = obs.RunLog(tmp_path / "shards.jsonl")
    parts = []
    for i in range(2):
        s = align_shard(al, fq, out=str(tmp_path / f"s{i}.sam"),
                        spec=f"{i}/2", batch_size=8, runlog=rl)
        obs.write_profile(tmp_path / f"s{i}.json", s["stats"],
                          wall_s=s["wall_s"],
                          meta={"shard": f"{i}/2", "reads": s["n_reads"],
                                "engine": "cuda"})
        parts.append(s)
    rl.close()
    paths = [str(tmp_path / "s0.json"), str(tmp_path / "s1.json")]
    merged = obs.merge_profiles([obs.read_profile(p) for p in paths],
                                paths=paths)
    for key in obs.SHARD_INVARIANT_COUNTERS:
        assert merged["snapshot"][key] == full["stats"][key], key
    assert merged["snapshot"]["io_reads"] == len(reads)
    full_body = sorted(ln for ln in
                       (tmp_path / "full.sam").read_text().splitlines()
                       if not ln.startswith("@"))
    shard_body = sorted(
        ln for i in range(2)
        for ln in (tmp_path / f"s{i}.sam").read_text().splitlines()
        if not ln.startswith("@"))
    assert shard_body == full_body
    walls = [p["wall_s"] for p in parts]
    assert merged["wall_s"] == max(walls)
    assert merged["meta"]["wall_sum_s"] == round(sum(walls), 6)
    assert [s["shard"] for s in merged["shards"]] == ["0/2", "1/2"]
    kinds = [e["event"] for e in obs.read_runlog(rl.path)]
    assert kinds.count("shard_start") == 2 and kinds.count("shard_end") == 2


def test_align_shard_wall_time_and_straggler(tmp_path, world):
    idx, reads, fq, _ = world
    al = cpu_aligner(idx, telemetry=True)
    mon = StragglerMonitor(window=8)
    s0 = align_shard(al, fq, out=str(tmp_path / "s0.sam"), spec="0/2",
                     monitor=mon, step=0)
    s1 = align_shard(al, fq, out=str(tmp_path / "s1.sam"), spec="1/2",
                     monitor=mon, step=1)
    assert s0["shard"] == (0, 2) and s1["shard"] == (1, 2)
    assert s0["wall_s"] > 0.0 and "straggler" in s0
    assert s0["n_reads"] + s1["n_reads"] == len(reads)
    merged = Snapshot.merge_all([s0["stats"], s1["stats"]])
    assert merged["io_reads"] == len(reads)
    assert merged["time_smem_s"] >= max(s0["stats"]["time_smem_s"],
                                        s1["stats"]["time_smem_s"])


def test_straggler_min_samples_and_wall_table():
    mon = StragglerMonitor(window=32, threshold=1.5)
    assert mon.min_samples == 8
    assert mon.observe(0, host=0, step_time=10.0) is None
    mon2 = StragglerMonitor(window=8, threshold=1.5, min_samples=2)
    assert mon2.observe(0, host=0, step_time=0.1) is None
    assert mon2.observe(1, host=1, step_time=0.1) is None
    ev = mon2.observe(2, host=2, step_time=1.0)
    assert ev is not None and ev.action == "rebalance"
    shards = [{"shard": "0/3", "wall_s": 1.0, "reads": 100},
              {"shard": "1/3", "wall_s": 1.1, "reads": 100},
              {"shard": "2/3", "wall_s": 9.0, "reads": 100}]
    table = obs.shard_wall_table(shards)
    flagged = [ln for ln in table.splitlines() if "STRAGGLER" in ln]
    assert len(flagged) == 1 and "2/3" in flagged[0]
    assert "median 1.100s over 3 shard(s)" in table
    assert table == robs.shard_wall_table(shards)
    empty = obs.shard_wall_table([{"shard": "0/1", "wall_s": None}])
    assert "no shard wall times" in empty


# ---------------------------------------------------------------------
# live export: atomicity under concurrency + Prometheus rendering
# ---------------------------------------------------------------------

def test_live_exporter_atomic_under_concurrent_writes(tmp_path):
    lock = threading.Lock()
    state = {"n": 0}
    reg = obs.MetricsRegistry()

    def source():
        with lock:
            snap = reg.snapshot()
            snap["writer_n"] = state["n"]
        return snap

    stop = threading.Event()

    def writer():
        with obs.activate(reg):
            while not stop.is_set():
                with lock:
                    with obs.span("bsw"):
                        obs.count("bsw_tasks", 3)
                        obs.observe("lanes", 64)
                    state["n"] += 1

    exp = obs.LiveExporter(tmp_path / "live", interval=0.002,
                           meta={"run": "test-run", "shard": "0/1"})
    t = threading.Thread(target=writer)
    t.start()
    try:
        exp.start(source)
        assert exp._thread.name == "repro-torch-live-export"
        with pytest.raises(RuntimeError, match="already started"):
            exp.start(source)
        deadline = time.time() + 0.3
        parses = 0
        while time.time() < deadline:
            with open(exp.json_path) as f:
                payload = json.load(f)
            assert payload["version"] == obs.EXPORT_VERSION
            assert payload["meta"]["run"] == "test-run"
            parses += 1
    finally:
        stop.set()
        t.join(timeout=10)
        exp.stop()
    assert not t.is_alive()
    exp.stop()
    assert parses > 0 and exp.n_flushes >= 2 and exp.last_error is None
    final = json.loads(open(exp.json_path).read())
    snap = Snapshot.from_jsonable(final["snapshot"])
    assert snap["writer_n"] == state["n"] > 0
    assert snap["bsw_tasks"] == 3 * state["n"]
    prom = open(exp.prom_path).read()
    assert "# TYPE repro_bsw_tasks counter" in prom
    assert 'repro_run_info{run="test-run",shard="0/1"} 1' in prom


def test_prometheus_text_rendering():
    h = Hist.new((1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    snap = Snapshot(sa_lookups=42, n_length_groups=Gauge(3.0), lanes=h,
                    pe_ok=True, note="skip me", mv=MultiValue([1, 2]))
    snap["time_kernel.bsw_s"] = 0.5
    text = obs.prometheus_text(snap, {"engine": "cuda"}, ts=123.0)
    assert 'repro_run_info{engine="cuda"} 1' in text
    assert "# TYPE repro_sa_lookups counter\nrepro_sa_lookups 42" in text
    assert "# TYPE repro_n_length_groups gauge" in text
    assert "# TYPE repro_lanes histogram" in text
    assert 'repro_lanes_bucket{le="1"} 1' in text
    assert 'repro_lanes_bucket{le="10"} 2' in text
    assert 'repro_lanes_bucket{le="+Inf"} 3' in text
    assert "repro_lanes_sum 55.5" in text and "repro_lanes_count 3" in text
    assert "repro_time_kernel_bsw_s 0.5" in text
    assert "pe_ok" not in text and "note" not in text and "mv" not in text
    assert "repro_export_timestamp_seconds 123.000" in text


def test_prometheus_text_equals_reference(world, tmp_path):
    """A real run's snapshot (counters, stage timers, gauges, histograms,
    per-batch payloads) renders to the same text in both packages."""
    idx, _, fq, _ = world
    # a stream's summary: its io_pad_frac histogram is the run's one
    snap = cpu_aligner(idx, telemetry=True).stream_sam(
        open_batches(fq, batch_size=8), str(tmp_path / "o.sam"))["stats"]
    meta = {"run": "r", "engine": "cuda", "shard": "0/1"}
    rsnap = RSnapshot.from_jsonable(json.loads(json.dumps(
        snap.to_jsonable())))
    assert obs.prometheus_text(snap, meta, ts=5.0) == \
        robs.prometheus_text(rsnap, meta, ts=5.0)
    assert sum(isinstance(v, Hist) for v in snap.values()) >= 1


# ---------------------------------------------------------------------
# report CLI: globs, --merge, single-file path unchanged, both packages
# ---------------------------------------------------------------------

def _fake_profile(path, *, shard, wall, reads):
    snap = Snapshot(io_reads=reads, sa_lookups=10 * reads,
                    time_bsw_s=wall / 2)
    obs.write_profile(path, snap, wall_s=wall,
                      meta={"shard": shard, "reads": reads,
                            "engine": "cuda"})


def test_report_cli_merge_and_globs(tmp_path, capsys):
    for i, wall in enumerate((1.0, 4.0)):
        _fake_profile(tmp_path / f"shard{i}.json", shard=f"{i}/2",
                      wall=wall, reads=50)
    merged_path = tmp_path / "merged.json"
    rc = cli_main(["report", "--merge", str(tmp_path / "shard*.json"),
                   "-o", str(merged_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "per-shard wall time" in out and "STRAGGLER" in out
    payload = obs.read_profile(merged_path)
    assert payload["snapshot"]["io_reads"] == 100
    assert payload["wall_s"] == 4.0
    assert payload["meta"]["merged_from"] == 2
    rc = cli_main(["report", str(tmp_path / "shard*.json"),
                   str(tmp_path / "shard0.json")])
    out = capsys.readouterr().out
    assert rc == 0 and "2 shard(s)" in out


def test_report_cli_single_file_unchanged(tmp_path, capsys):
    _fake_profile(tmp_path / "one.json", shard="0/1", wall=2.0, reads=25)
    rc = cli_main(["report", str(tmp_path / "one.json")])
    assert rc == 0
    payload = obs.read_profile(tmp_path / "one.json")
    expected = obs.render(payload["snapshot"], wall_s=payload["wall_s"],
                          meta=payload["meta"])
    assert capsys.readouterr().out == expected + "\n"
    rc = cli_main(["report", str(tmp_path / "missing.json")])
    assert rc == 2


def test_report_merge_across_packages(world, tmp_path, capsys):
    """Shard 0 profiled by the port's ``mem`` and shard 1 by the
    reference's: both ``report --merge -o`` write the same merged
    profile.  The one difference is by design: the counters section of
    the breakdown lists each package's own ``COUNTERS`` (the port shows
    SMEM transfer bytes, the reference its occ dispatches); every
    counter of either side stays in the merged snapshot."""
    _, reads, fq, fa = world
    p0, p1 = str(tmp_path / "p0.json"), str(tmp_path / "p1.json")
    assert cli_main(["mem", fa, fq, "--shard", "0/2", "--device", "cpu",
                     "--no-pg", "--profile", p0, "-o",
                     str(tmp_path / "s0.sam")]) == 0
    assert rcli.main(["mem", fa, fq, "--shard", "1/2", "--engine",
                      "pallas", "--no-pg", "--profile", p1, "-o",
                      str(tmp_path / "s1.sam")]) == 0
    # a profiled run also leaves its run log and live files
    for p in (p0, p1):
        stem = p[:-len(".json")]
        assert obs.read_runlog(f"{stem}.runlog.jsonl")[-1]["status"] == "ok"
        json.loads(open(f"{stem}.live.json").read())
    m_t, m_r = tmp_path / "m_t.json", tmp_path / "m_r.json"
    assert cli_main(["report", "--merge", p0, p1, "-o", str(m_t)]) == 0
    assert rcli.main(["report", "--merge", p0, p1, "-o", str(m_r)]) == 0
    capsys.readouterr()
    got, want = json.loads(m_t.read_text()), json.loads(m_r.read_text())
    counters_t = got["breakdown"].pop("counters")
    counters_r = want["breakdown"].pop("counters")
    assert got == want
    assert got["snapshot"]["io_reads"] == len(reads)
    snap = Snapshot.from_jsonable(got["snapshot"])
    assert {"smem_h2d_bytes", "smem_occ_dispatches"} <= set(snap)
    assert "smem_h2d_bytes" in counters_t and \
        "smem_occ_dispatches" in counters_r
    shared = set(counters_t) & set(counters_r)
    assert {k: counters_t[k] for k in shared} == \
        {k: counters_r[k] for k in shared}
    assert [s["engine"] for s in got["shards"]] == ["cuda", "pallas"]
    assert np.all(np.array([s["reads"] for s in got["shards"]]) > 0)


def test_engine_override_per_call(world, tmp_path):
    """``engine=`` picks a registered driver pair for one call (what
    ``serve`` coalesces by); an unknown name raises before any work."""
    from repro_torch import api
    from repro_torch.kernels.engine import run_pe_cuda, run_se_cuda
    idx, reads, fq, _ = world
    calls = []

    def se(*a, **k):
        calls.append("se")
        return run_se_cuda(*a, **k)

    def pe(*a, **k):
        calls.append("pe")
        return run_pe_cuda(*a, **k)

    api.register_engine("counting", se, pe, replace=True)
    try:
        al = cpu_aligner(idx)
        want = al.align(reads).sam()
        assert al.align(reads, engine="counting").sam() == want
        assert al.align_pairs(reads[:4], reads[4:8], engine="counting").paired
        al.estimate_pe_stats(reads[:4], reads[4:8], engine="counting")
        out = tmp_path / "o.sam"
        al.stream_sam(open_batches(fq, batch_size=8), str(out),
                      engine="counting")
        assert calls == ["se", "pe", "se", "se", "se"]
        for call in (lambda: al.align(reads, engine="nope"),
                     lambda: al.align_pairs(reads[:2], reads[2:4],
                                            engine="nope"),
                     lambda: al.estimate_pe_stats(reads[:2], reads[2:4],
                                                  engine="nope")):
            with pytest.raises(ValueError, match="unknown engine 'nope'"):
                call()
        assert calls == ["se", "pe", "se", "se", "se"]
    finally:
        # keep the process-global registry pristine for later tests
        del api._ENGINES["counting"]
