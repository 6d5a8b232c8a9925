"""Structured, run-scoped JSONL event log.

The ``--profile`` telemetry is post-hoc: a ``Snapshot`` you only see
once the process exits cleanly.  A 1000-shard distributed ``mem`` (or the
always-on alignment service) needs observability that SURVIVES the
process — a persistent record of what ran, how far it got, what it
warned about, and (when it died) what it was doing.  ``RunLog`` is that
record: an append-only JSONL stream, one self-describing event per
line, flushed per event so a crash loses at most the line being
written.

Every event shares one envelope::

    {"v": 1, "run": "<run id>", "seq": N, "t": <s since open>,
     "ts": <unix time>, "event": "<name>", ...event fields...}

``seq`` is strictly increasing per file (``read_runlog`` verifies it),
``run`` ties the file to one invocation, and ``t`` is monotonic time so
per-batch rates survive clock steps.  Well-known events:

* ``run_start``   — the manifest: tool, argv, pid/host/python, engine,
  the full flattened ``AlignOptions``, the index fingerprint
  (``index_fingerprint``), shard identity;
* ``batch``       — per-batch progress: batch ordinal, sizes, cumulative
  reads/records, instantaneous + cumulative reads/s, ETA when a total
  is known;
* ``stream_start`` / ``stream_end`` — one ``Aligner.stream_sam`` call;
* ``shard_start`` / ``shard_end``   — one ``dist.api.align_shard`` call
  (shard identity, wall time, straggler verdict);
* ``warning``     — a Python warning captured structurally (see
  ``capture_warnings``) instead of evaporating on stderr;
* ``crash``       — the diagnostic bundle: exception + traceback tail,
  the PARTIAL metrics ``Snapshot`` at failure time, the last completed
  batch's context, and the tail of the trace-event buffer;
* ``run_end``     — terminal status + summary counters.

The log never touches alignment output: SAM stays byte-identical with
the run log enabled or disabled (tested).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import platform
import secrets
import sys
import threading
import time
import traceback
import warnings

RUNLOG_VERSION = 1

#: cap on traceback / trace-tail payloads inside a crash bundle
CRASH_TRACEBACK_LIMIT = 30
CRASH_TRACE_TAIL = 32


def new_run_id() -> str:
    """Sortable, collision-safe run id: utc timestamp + pid + entropy."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    return f"{stamp}-{os.getpid():x}-{secrets.token_hex(3)}"


def index_fingerprint(idx) -> dict:
    """Small, stable identity of an FM-index/ContigIndex for the run
    manifest — enough to tell two runs used the same reference without
    hashing gigabytes: total length, contig count, and a digest of the
    contig name/length table."""
    fp: dict = {"N": int(getattr(idx, "N", 0))}
    names = tuple(getattr(idx, "names", ()) or ())
    lengths = getattr(idx, "lengths", None)
    if names:
        fp["n_contigs"] = len(names)
        table = ";".join(
            f"{n}:{int(ln)}" for n, ln in
            zip(names, lengths if lengths is not None else [-1] * len(names)))
        fp["contigs_sha1"] = hashlib.sha1(table.encode()).hexdigest()[:12]
        if len(names) <= 8:
            fp["contigs"] = list(names)
    return fp


def _jsonable_options(options) -> dict | None:
    if options is None:
        return None
    if dataclasses.is_dataclass(options):
        return dataclasses.asdict(options)
    return dict(options)


class RunLog:
    """Append-only JSONL event stream for ONE run (thread-safe).

    Construct with a path (the file is truncated — one run per file),
    emit events via the helpers, ``close()`` when done (or use it as a
    context manager).  Every emit flushes, so the file is live-tailable
    and crash-robust.
    """

    def __init__(self, path, *, run_id: str | None = None):
        self.path = os.fspath(path)
        self.run_id = run_id or new_run_id()
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._seq = 0
        self._fh = open(self.path, "w")

    # -- core --

    def emit(self, event: str, **fields) -> dict | None:
        """Append one event line (None after close — emitting from a
        ``finally`` path after shutdown must never raise)."""
        with self._lock:
            if self._fh is None:
                return None
            rec = {"v": RUNLOG_VERSION, "run": self.run_id,
                   "seq": self._seq, "t": round(
                       time.perf_counter() - self._t0, 6),
                   "ts": round(time.time(), 3), "event": event}
            rec.update(fields)
            self._seq += 1
            # default=str: logging must never crash the run over a
            # non-JSON payload (numpy scalars, paths, exceptions)
            self._fh.write(json.dumps(rec, default=str) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    @property
    def closed(self) -> bool:
        return self._fh is None

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- well-known events --

    def manifest(self, tool: str, *, argv=None, engine: str | None = None,
                 options=None, index=None, **fields) -> dict | None:
        """The ``run_start`` event: everything needed to reproduce the
        invocation (options are the flattened AlignOptions dict, index
        is an ``index_fingerprint``)."""
        if index is not None and not isinstance(index, dict):
            index = index_fingerprint(index)
        return self.emit(
            "run_start", tool=tool, pid=os.getpid(),
            host=platform.node(), python=sys.version.split()[0],
            argv=list(argv) if argv is not None else None,
            engine=engine, options=_jsonable_options(options),
            index=index, **fields)

    def batch(self, i: int, *, reads: int, records: int, batch_s: float,
              reads_total: int, records_total: int, elapsed_s: float,
              total_reads: int | None = None, **fields) -> dict | None:
        """One ``batch`` progress event; rates are computed here so
        every producer reports them the same way."""
        rate = reads_total / elapsed_s if elapsed_s > 0 else 0.0
        eta = None
        if total_reads and rate > 0:
            eta = round(max(total_reads - reads_total, 0) / rate, 3)
        return self.emit("batch", i=i, reads=reads, records=records,
                         batch_s=round(batch_s, 6),
                         reads_total=reads_total,
                         records_total=records_total,
                         reads_per_s=round(rate, 3), eta_s=eta, **fields)

    def warning(self, message: str, category: str,
                filename: str | None = None,
                lineno: int | None = None) -> dict | None:
        return self.emit("warning", message=str(message), category=category,
                         where=(f"{filename}:{lineno}" if filename else None))

    def crash(self, exc: BaseException, *, snapshot=None, batch=None,
              trace_tail=None) -> dict | None:
        """The diagnostic bundle for an in-flight failure: what broke,
        what the metrics looked like, what was being processed, and the
        last trace events before the end."""
        tb = traceback.format_exception(
            type(exc), exc, exc.__traceback__, limit=CRASH_TRACEBACK_LIMIT)
        snap = None
        if snapshot is not None:
            snap = (snapshot.to_jsonable()
                    if hasattr(snapshot, "to_jsonable") else dict(snapshot))
        tail = list(trace_tail)[-CRASH_TRACE_TAIL:] if trace_tail else None
        return self.emit("crash", exc_type=type(exc).__name__,
                         message=str(exc), traceback="".join(tb),
                         snapshot=snap, batch=batch, trace_tail=tail)

    def end(self, status: str = "ok", **fields) -> dict | None:
        return self.emit("run_end", status=status, **fields)

    # -- structured warning capture --

    @contextlib.contextmanager
    def capture_warnings(self):
        """Route every warning shown inside the block into the run log
        as a structured ``warning`` event, THEN forward it to the
        previous ``warnings.showwarning`` — nothing is lost from stderr,
        but the run record keeps it (e.g. the ``RuntimeWarning`` of
        ``dist.api.read_shard``'s unsharded fallback).  Warning
        FILTERS are untouched: a warning configured as an error still
        raises."""
        prev = warnings.showwarning

        def show(message, category, filename, lineno,
                 file=None, line=None):
            self.warning(str(message), category.__name__, filename, lineno)
            prev(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        try:
            yield self
        finally:
            warnings.showwarning = prev


def read_runlog(path) -> list[dict]:
    """Parse + validate a run-log JSONL file back into event dicts.

    Checks the envelope every event must carry (version, one run id,
    strictly-increasing ``seq``) so consumers can trust ordering and
    detect truncation/interleaving; raises ``ValueError`` on violation.
    """
    events: list[dict] = []
    run_id = None
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{n}: bad JSONL line: {e}")
            for key in ("v", "run", "seq", "t", "ts", "event"):
                if key not in ev:
                    raise ValueError(f"{path}:{n}: event missing {key!r}")
            if ev["v"] != RUNLOG_VERSION:
                raise ValueError(f"{path}:{n}: unsupported run-log "
                                 f"version {ev['v']!r}")
            if run_id is None:
                run_id = ev["run"]
            elif ev["run"] != run_id:
                raise ValueError(f"{path}:{n}: mixed run ids "
                                 f"({run_id!r} vs {ev['run']!r})")
            if events and ev["seq"] <= events[-1]["seq"]:
                raise ValueError(f"{path}:{n}: seq not increasing "
                                 f"({events[-1]['seq']} -> {ev['seq']})")
            events.append(ev)
    return events
