"""Live metrics export: atomic snapshot JSON + Prometheus textfile.

The ``--profile`` artifact only exists AFTER a run finishes; a
long-running sharded ``mem`` or the alignment service must be
observable while in flight.  ``LiveExporter`` runs a small daemon
thread that periodically pulls a ``Snapshot`` from a caller-supplied
source and atomically rewrites two files:

* ``<prefix>.json`` — the raw mergeable ``Snapshot`` (``to_jsonable``
  encoding, same as the ``--profile`` artifact's ``snapshot`` field)
  plus export metadata (run id, sequence number, timestamp);
* ``<prefix>.prom`` — Prometheus exposition-format text, ready for the
  node-exporter textfile collector (or any file-scraping agent):
  counters, gauges, and histograms with cumulative ``le`` buckets.

Atomicity is write-to-temp + ``os.replace`` — a scraper never sees a
half-written file, even with the exporter rewriting at a short
interval under concurrent metric writes (tested).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from .metrics import NUMERIC, Gauge, Hist, Snapshot

EXPORT_VERSION = 1

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def write_atomic(path, text: str) -> None:
    """Atomically replace ``path`` with ``text`` (temp file + rename in
    the same directory, so the rename never crosses filesystems)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _prom_name(key: str) -> str:
    name = _NAME_RE.sub("_", str(key))
    if not name or name[0].isdigit():
        name = f"_{name}"
    return f"repro_{name}"


def _prom_label(v) -> str:
    s = str(v)
    for raw, esc in _LABEL_ESC.items():
        s = s.replace(raw, esc)
    return s


def prometheus_text(snap: dict, meta: dict | None = None, *,
                    ts: float | None = None) -> str:
    """Render a ``Snapshot`` as Prometheus exposition text.

    Numeric entries become counters (the registry only accumulates),
    ``Gauge`` entries gauges, ``Hist`` entries histograms with
    cumulative ``le`` buckets; non-numeric payloads (``MultiValue``,
    strings) are skipped — they have no metric shape.  ``meta`` is
    surfaced as the label set of a ``repro_run_info`` gauge.
    """
    lines: list[str] = []
    if meta:
        labels = ",".join(f'{_NAME_RE.sub("_", str(k))}="{_prom_label(v)}"'
                          for k, v in sorted(meta.items()))
        lines.append("# TYPE repro_run_info gauge")
        lines.append(f"repro_run_info{{{labels}}} 1")
    for key in sorted(snap, key=str):
        v = snap[key]
        name = _prom_name(key)
        if isinstance(v, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(v):.17g}")
        elif isinstance(v, Hist):
            lines.append(f"# TYPE {name} histogram")
            acc = 0
            for edge, c in zip(v.edges, v.counts):
                acc += c
                lines.append(f'{name}_bucket{{le="{edge:g}"}} {acc}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {v.count}')
            lines.append(f"{name}_sum {v.total:.17g}")
            lines.append(f"{name}_count {v.count}")
        elif isinstance(v, bool):
            continue
        elif isinstance(v, NUMERIC):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {float(v):.17g}")
    lines.append("# TYPE repro_export_timestamp_seconds gauge")
    lines.append(f"repro_export_timestamp_seconds "
                 f"{(time.time() if ts is None else ts):.3f}")
    return "\n".join(lines) + "\n"


class LiveExporter:
    """Periodic atomic flusher of a live metrics source.

    ``start(source)`` begins flushing ``source()`` (a zero-arg callable
    returning a ``Snapshot``; it must be safe to call from another
    thread — ``Aligner.stream_sam`` hands one guarded by its own lock)
    every ``interval`` seconds; ``stop()`` joins the thread and writes
    one final flush so the files always end at the complete run state.
    Both are idempotent; the exporter can also be driven manually with
    ``flush()`` and no thread.
    """

    def __init__(self, prefix, *, interval: float = 1.0,
                 meta: dict | None = None):
        prefix = os.fspath(prefix)
        self.json_path = prefix + ".json"
        self.prom_path = prefix + ".prom"
        self.interval = float(interval)
        self.meta = dict(meta or {})
        self.n_flushes = 0
        self.last_error: Exception | None = None
        self._source = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def flush(self) -> None:
        """One atomic rewrite of both files from the current source."""
        if self._source is None:
            return
        snap = self._source()
        if not isinstance(snap, Snapshot):
            snap = Snapshot(snap)
        now = time.time()
        self.n_flushes += 1
        payload = {"version": EXPORT_VERSION, "ts": round(now, 3),
                   "seq": self.n_flushes, "meta": self.meta,
                   "snapshot": snap.to_jsonable()}
        write_atomic(self.json_path, json.dumps(payload, indent=1) + "\n")
        write_atomic(self.prom_path,
                     prometheus_text(snap, self.meta, ts=now))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.flush()
            except Exception as e:     # keep exporting; surface on stop()
                self.last_error = e

    def start(self, source) -> "LiveExporter":
        if self._thread is not None:
            raise RuntimeError("LiveExporter already started")
        self._source = source
        self._stop.clear()
        self.flush()                   # files exist from t=0
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-torch-live-export",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent shutdown + final flush (foreground, so a flush
        error here DOES raise — the terminal state must be truthful)."""
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=10.0)
        if self._source is not None:
            self.flush()
