"""The persistent alignment server of the port: one index, continuous
batching, the hand-written kernels on the card.

``AlignmentServer`` loads/wraps the FM-index ONCE and shares it across
every request: each accepted TCP connection gets a reader thread that
parses frames (``serve.protocol``), validates them, and enqueues
``Request``s into the bounded ``RequestQueue``; one scheduler thread
pops the oldest request, coalesces every queued request of the same
cohort into one full-width length-sorted padded batch
(``io.stream._pack_se`` / ``_pack_pe``), runs it through a per-cohort
``Aligner``, and splits the resulting SAM stream back per request.

Device: ``options.device`` (``"cuda"`` by default, as for ``Aligner``)
is resolved once, in the constructor, so a server asked for the card
raises ``RuntimeError`` without one before it binds a socket.  Every
cohort's ``Aligner`` runs on that device: a request's ``flags`` are bwa
flags (``BWA_FLAGS``), which name no device, so no client can move work
off the card.  The scheduler thread launches the kernels, on its current
(the default) stream.

Conformance contract: the SAM lines streamed back for one request are
byte-identical to an offline ``Aligner.stream_sam`` over the same reads
and options, however requests were coalesced.  SE coalescing is always
safe (per-read output is batch-composition-independent); PE requests
only share an engine batch when the server was given frozen insert-size
stats (``pe_stats=...``), otherwise each runs as its own batch — both
matching the offline single-batch run.

Lifecycle: ``start()`` binds and spawns threads; ``shutdown(drain=True)``
stops accepting new work, lets the scheduler drain every queued request,
then stops the exporter/runlog.  Per-request deadlines return a
structured ``deadline`` error without poisoning the rest of the batch;
a full queue returns ``overloaded`` (backpressure); dead client
connections are detected on send and skipped, never aborting the batch.

Observability: a server-wide ``MetricsRegistry`` (queue depth gauge,
coalesce-width/pad-waste hists, request/error counters) merged with the
per-batch engine Snapshots feeds an optional ``obs.LiveExporter``
(Prometheus textfile + JSON, rewritten while serving) and an optional
``obs.RunLog`` records ``request`` / ``batch_coalesced`` /
``request_done`` / ``request_error`` events.
"""

from __future__ import annotations

import socket
import threading
import time

from .. import obs
from ..api import Aligner, resolve_device
from ..io.stream import _pack_pe, _pack_se
from ..options import AlignOptions, BWA_FLAGS
from . import protocol
from .batcher import Overloaded, QueueClosed, Request, RequestQueue

#: Default cap on a single read's length (frames above are rejected with
#: ``read_too_long`` — the engines pad every batch row to the widest
#: read, so one huge read would poison its whole cohort's padding).
MAX_READ_LEN = 4096


class _Conn:
    """One client connection: socket + send lock + liveness flag."""

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        self.alive = True
        self._send_lock = threading.Lock()

    def send(self, obj: dict) -> bool:
        """Send one frame; on failure mark the connection dead and
        return False (the scheduler skips dead requesters mid-batch)."""
        if not self.alive:
            return False
        try:
            with self._send_lock:
                protocol.send_frame(self.sock, obj)
            return True
        except OSError:
            self.alive = False
            return False

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class AlignmentServer:
    """Persistent, continuously-batching alignment service over TCP."""

    def __init__(self, index, options: AlignOptions | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch_reads: int = 512, max_queue: int = 64,
                 max_read_len: int = MAX_READ_LEN,
                 pe_stats=None, telemetry: bool = True,
                 runlog: "obs.RunLog | None" = None,
                 exporter: "obs.LiveExporter | None" = None):
        self.index = index
        options = options or AlignOptions()
        # no card for a server asked for one: raise here, before start()
        # binds; never carry on on the CPU
        self.options = options.replace(
            device=str(resolve_device(options.device)))
        self.host = host
        self.port = port
        self.max_batch_reads = max(1, int(max_batch_reads))
        self.max_read_len = int(max_read_len)
        self.pe_stats = None if pe_stats is None else list(pe_stats)
        self.telemetry = telemetry
        self.runlog = runlog
        self.exporter = exporter
        self.queue = RequestQueue(maxsize=max_queue)
        self.metrics = obs.MetricsRegistry()
        self._stats = obs.Snapshot()            # merged engine snapshots
        self._stats_lock = threading.Lock()
        self._aligners: dict[AlignOptions, Aligner] = {}
        self._aligners_lock = threading.Lock()
        self._gate = threading.Event()          # pause()/resume()
        self._gate.set()
        self._accepting = False
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set[_Conn] = set()
        self._conns_lock = threading.Lock()
        self._drained = threading.Event()

    # -- lifecycle --

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> tuple[str, int]:
        """Bind, spawn the acceptor + scheduler, return (host, port)."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._accepting = True
        if self.runlog is not None:
            self.runlog.emit("serve_start", host=self.host, port=self.port,
                             engine=self.options.engine,
                             max_batch_reads=self.max_batch_reads,
                             max_queue=self.queue.maxsize,
                             max_read_len=self.max_read_len,
                             pe_coalesce=self.pe_stats is not None)
        if self.exporter is not None:
            self.exporter.start(self.live_stats)
        for name, fn in (("serve-accept", self._accept_loop),
                         ("serve-sched", self._scheduler_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return (self.host, self.port)

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting; drain queued requests (unless ``drain=False``,
        which errors them out), then stop exporter/runlog."""
        self._accepting = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if not drain:
            for r in self._drain_all():
                self._send_error(r, protocol.ERR_SHUTDOWN,
                                 "server shutting down")
        self.queue.close()
        self._gate.set()                      # a paused server still drains
        self._drained.wait(timeout=timeout)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        if self.exporter is not None:
            self.exporter.stop()
        if self.runlog is not None:
            self.runlog.emit("serve_stop", drained=self._drained.is_set())
            self.runlog.end(status="ok")
            self.runlog.close()

    def pause(self) -> None:
        """Hold the scheduler (requests keep queueing) — lets tests and
        the bench build a deterministic coalescable backlog."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    def _drain_all(self) -> list[Request]:
        out = []
        while True:
            try:
                out.append(self.queue.get(timeout=0.01))
            except (QueueClosed, TimeoutError):
                return out

    # -- stats --

    def live_stats(self) -> obs.Snapshot:
        """Thread-safe merged view: server registry + engine snapshots
        (the ``LiveExporter`` source)."""
        with self._stats_lock:
            merged = obs.Snapshot().merge_in(self._stats)
        merged.merge_in(self.metrics.snapshot())
        return merged

    # -- connection handling --

    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return                        # listener closed by shutdown
            conn = _Conn(sock, f"{addr[0]}:{addr[1]}")
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name=f"serve-conn-{conn.peer}", daemon=True)
            t.start()

    def _conn_loop(self, conn: _Conn) -> None:
        try:
            while conn.alive:
                try:
                    frame = protocol.recv_frame(conn.sock)
                except protocol.ProtocolError as e:
                    conn.send({"type": "error", "id": None,
                               "code": protocol.ERR_BAD_REQUEST,
                               "message": str(e)})
                    return
                except OSError:
                    return
                if frame is None:             # client hung up cleanly
                    return
                self._handle_frame(conn, frame)
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle_frame(self, conn: _Conn, frame: dict) -> None:
        op = frame.get("op")
        rid = frame.get("id")
        if op == "ping":
            conn.send({"type": "pong", "engine": self.options.engine,
                       "queue_depth": len(self.queue),
                       "accepting": self._accepting})
            return
        if op not in ("align", "align_pairs"):
            conn.send({"type": "error", "id": rid,
                       "code": protocol.ERR_BAD_REQUEST,
                       "message": f"unknown op {op!r}"})
            return
        try:
            req = self._parse_request(conn, frame)
        except _Reject as e:
            self.metrics.inc("serve_errors")
            conn.send({"type": "error", "id": rid, "code": e.code,
                       "message": str(e)})
            return
        if self.runlog is not None:
            self.runlog.emit("request", id=req.id, op=req.op,
                             reads=req.n_reads, peer=conn.peer,
                             engine=req.engine or req.options.engine)
        self.metrics.inc("serve_requests")
        if not req.seqs:                      # zero-read: answer inline
            if req.header:
                conn.send({"type": "header", "id": req.id,
                           "lines": self._aligner_for(req.options)
                                        .sam_header()})
            conn.send({"type": "end", "id": req.id, "n_records": 0})
            return
        if not self._accepting:
            self.metrics.inc("serve_errors")
            conn.send({"type": "error", "id": req.id,
                       "code": protocol.ERR_SHUTDOWN,
                       "message": "server shutting down"})
            return
        try:
            self.queue.put(req)
        except (Overloaded, QueueClosed) as e:
            self.metrics.inc("serve_errors")
            code = (protocol.ERR_OVERLOADED if isinstance(e, Overloaded)
                    else protocol.ERR_SHUTDOWN)
            conn.send({"type": "error", "id": req.id, "code": code,
                       "message": str(e) or "server shutting down"})
            return
        self.metrics.set_gauge("serve_queue_depth", len(self.queue))

    def _parse_request(self, conn: _Conn, frame: dict) -> Request:
        rid = str(frame.get("id", ""))
        op = frame["op"]
        items = frame.get("reads" if op == "align" else "pairs")
        if not isinstance(items, list):
            raise _Reject(protocol.ERR_BAD_REQUEST,
                          f"{op} needs a list of "
                          f"{'reads' if op == 'align' else 'pairs'}")
        names, seqs = [], []
        width = 2 if op == "align" else 3
        for it in items:
            if (not isinstance(it, (list, tuple)) or len(it) != width or
                    not all(isinstance(x, str) for x in it)):
                raise _Reject(protocol.ERR_BAD_REQUEST,
                              f"each entry must be {width} strings")
            names.append(it[0])
            seq = it[1] if op == "align" else (it[1], it[2])
            for s in ((seq,) if op == "align" else seq):
                if not s:
                    raise _Reject(protocol.ERR_BAD_REQUEST,
                                  f"empty sequence for read {it[0]!r}")
                if len(s) > self.max_read_len:
                    raise _Reject(protocol.ERR_READ_TOO_LONG,
                                  f"read {it[0]!r} is {len(s)} bp; the "
                                  f"server caps reads at "
                                  f"{self.max_read_len} bp")
            seqs.append(seq)
        flags = frame.get("flags") or {}
        if not isinstance(flags, dict):
            raise _Reject(protocol.ERR_BAD_REQUEST, "flags must be a map")
        try:
            unknown = set(flags) - set(BWA_FLAGS)
            if unknown:
                raise ValueError(f"unknown flag(s) "
                                 f"{' '.join(sorted(unknown))}")
            options = (AlignOptions.from_flags(flags, base=self.options)
                       if flags else self.options)
        except (ValueError, TypeError) as e:
            raise _Reject(protocol.ERR_BAD_REQUEST, str(e))
        deadline_s = frame.get("deadline_s")
        deadline = None
        if deadline_s is not None:
            try:
                deadline = time.monotonic() + float(deadline_s)
            except (TypeError, ValueError):
                raise _Reject(protocol.ERR_BAD_REQUEST,
                              f"bad deadline_s {deadline_s!r}")
        engine = frame.get("engine")
        if engine is not None and not isinstance(engine, str):
            raise _Reject(protocol.ERR_BAD_REQUEST, "engine must be a name")
        return Request(id=rid, op=op, names=names, seqs=seqs,
                       options=options, engine=engine,
                       header=bool(frame.get("header")),
                       deadline=deadline, conn=conn)

    # -- scheduling --

    def _aligner_for(self, options: AlignOptions) -> Aligner:
        """Per-cohort facade over the ONE shared index (thread-safe:
        engine state is per-call; see tests/test_torch_serve_threads.py).
        ``options`` carries the server's device: no cohort leaves it."""
        with self._aligners_lock:
            al = self._aligners.get(options)
            if al is None:
                al = Aligner(self.index, options,
                             telemetry=self.telemetry,
                             pe_stats=self.pe_stats)
                self._aligners[options] = al
            return al

    def _scheduler_loop(self) -> None:
        try:
            while True:
                try:
                    req = self.queue.get()
                except QueueClosed:
                    return
                self._gate.wait()
                coalesce_pe = self.pe_stats is not None
                key = req.cohort_key(coalesce_pe)
                group = [req] + self.queue.take_cohort(
                    key, coalesce_pe,
                    budget_reads=self.max_batch_reads - req.n_reads)
                self.metrics.set_gauge("serve_queue_depth", len(self.queue))
                try:
                    self._process_group(group)
                except Exception as e:          # engine bug: fail the group
                    if self.runlog is not None:
                        self.runlog.crash(e)
                    for r in group:
                        self._send_error(r, protocol.ERR_INTERNAL,
                                         f"{type(e).__name__}: {e}")
        finally:
            self._drained.set()

    def _process_group(self, group: list[Request]) -> None:
        live = []
        for r in group:
            if r.expired():
                self._send_error(r, protocol.ERR_DEADLINE,
                                 "deadline exceeded before scheduling",
                                 timeout=True)
            elif not r.conn.alive:
                self.metrics.inc("serve_dropped")
            else:
                live.append(r)
        if not live:
            return
        first = live[0]
        aligner = self._aligner_for(first.options)
        t0 = time.perf_counter()
        n_reads = sum(r.n_reads for r in live)
        if first.op == "align":
            names = [n for r in live for n in r.names]
            seqs = [s for r in live for s in r.seqs]
            batch = _pack_se(names, seqs)
            res = aligner.align(batch, engine=first.engine)
            # one SAM line per emitted alignment, or one unmapped
            # placeholder — the exact per-read layout of the offline run
            counts = [max(1, len(a)) for a in res.alignments]
        else:
            names = [n for r in live for n in r.names]
            s1 = [s[0] for r in live for s in r.seqs]
            s2 = [s[1] for r in live for s in r.seqs]
            batch = _pack_pe(names, s1, s2)
            res = aligner.align_pairs(batch, engine=first.engine)
            counts = [2] * (n_reads // 2)       # emit_pair: 2 lines/pair
        wall = time.perf_counter() - t0
        lines = res.sam()
        self._note_batch(live, first, batch, n_reads, len(lines), wall,
                         res.stats)
        # split the batch's SAM stream back per request, FIFO
        edges = []
        pos = 0
        ci = 0
        for r in live:
            n_items = len(r.seqs)
            n_lines = sum(counts[ci:ci + n_items])
            edges.append((pos, pos + n_lines))
            pos += n_lines
            ci += n_items
        for r, (lo, hi) in zip(live, edges):
            self._respond(r, aligner, lines[lo:hi])

    def _respond(self, r: Request, aligner: Aligner,
                 lines: list[str]) -> None:
        if r.expired():
            self._send_error(r, protocol.ERR_DEADLINE,
                             "deadline exceeded during alignment",
                             timeout=True)
            return
        ok = True
        if r.header:
            ok = r.conn.send({"type": "header", "id": r.id,
                              "lines": aligner.sam_header()})
        if ok:
            ok = r.conn.send({"type": "sam", "id": r.id, "lines": lines})
        if ok:
            ok = r.conn.send({"type": "end", "id": r.id,
                              "n_records": len(lines)})
        if not ok:
            self.metrics.inc("serve_dropped")
        if self.runlog is not None:
            self.runlog.emit("request_done", id=r.id,
                             n_records=len(lines), delivered=ok,
                             wait_s=round(time.monotonic() - r.received, 6))

    def _send_error(self, r: Request, code: str, message: str,
                    timeout: bool = False) -> None:
        self.metrics.inc("serve_timeouts" if timeout else "serve_errors")
        r.conn.send({"type": "error", "id": r.id, "code": code,
                     "message": message})
        if self.runlog is not None:
            self.runlog.emit("request_error", id=r.id, code=code)

    def _note_batch(self, live, first: Request, batch, n_reads: int,
                    n_lines: int, wall: float, stats) -> None:
        if first.op == "align":
            cells = batch.reads.size
            bases = int(batch.lens.sum())
        else:
            cells = batch.reads1.size + batch.reads2.size
            bases = int(batch.lens1.sum() + batch.lens2.sum())
        self.metrics.inc("serve_batches")
        self.metrics.inc("serve_reads", n_reads)
        self.metrics.observe("serve_coalesce_width", len(live))
        if cells:
            self.metrics.observe("serve_pad_frac",
                                 (cells - bases) / cells,
                                 edges=obs.RATIO_EDGES)
        with self._stats_lock:
            self._stats.merge_in(stats)
        if self.runlog is not None:
            self.runlog.emit("batch_coalesced", op=first.op,
                             requests=len(live), reads=n_reads,
                             records=n_lines,
                             engine=first.engine or first.options.engine,
                             pad_frac=round((cells - bases) / cells, 4)
                             if cells else 0.0,
                             batch_s=round(wall, 6))


class _Reject(Exception):
    """Request-validation failure -> one structured error frame."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
