"""Thin client for the alignment service (``repro_torch.serve``; a copy
of ``repro.serve.client``, and either client talks to either server).

Connects over TCP, speaks the length-prefixed JSON protocol, and exposes
the two alignment calls as blocking methods that collect one request's
response stream::

    from repro_torch.serve.client import ServeClient

    with ServeClient.connect("127.0.0.1", 7878) as c:
        res = c.align([("r0", "ACGT..."), ("r1", "TTAG...")], header=True)
        print("\\n".join(res.header + res.sam))
        pe = c.align_pairs([("p0", "ACGT...", "TGCA...")],
                           flags={"-T": 25})

Each call returns a :class:`ServeResult`; structured server errors
(backpressure, deadline, oversized read, shutdown) raise
:class:`ServeError` carrying the machine-readable ``code``.  One client
holds one socket and is NOT thread-safe — use one client per thread (the
server happily serves many connections).
"""

from __future__ import annotations

import dataclasses
import socket

from . import protocol

__all__ = ["ServeClient", "ServeError", "ServeResult"]


class ServeError(Exception):
    """Structured error frame from the server (see protocol.ERR_*)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


@dataclasses.dataclass
class ServeResult:
    """One request's collected response stream."""
    id: str
    header: list[str]            # @SQ/@RG lines ([] unless header=True)
    sam: list[str]               # SAM body lines, offline-identical
    n_records: int


class ServeClient:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._next_id = 0

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: float | None = None) -> "ServeClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # -- requests --

    def align(self, reads, *, flags: dict | None = None,
              engine: str | None = None, header: bool = False,
              deadline_s: float | None = None,
              request_id: str | None = None) -> ServeResult:
        """Single-end request: ``reads`` is ``[(name, seq), ...]``."""
        return self._request("align", "reads",
                             [[n, s] for (n, s) in reads],
                             flags, engine, header, deadline_s, request_id)

    def align_pairs(self, pairs, *, flags: dict | None = None,
                    engine: str | None = None, header: bool = False,
                    deadline_s: float | None = None,
                    request_id: str | None = None) -> ServeResult:
        """Paired-end request: ``pairs`` is ``[(name, seq1, seq2), ...]``."""
        return self._request("align_pairs", "pairs",
                             [[n, s1, s2] for (n, s1, s2) in pairs],
                             flags, engine, header, deadline_s, request_id)

    def ping(self) -> dict:
        protocol.send_frame(self._sock, {"op": "ping"})
        frame = protocol.recv_frame(self._sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        return frame

    def _request(self, op, field, items, flags, engine, header,
                 deadline_s, request_id) -> ServeResult:
        if request_id is None:
            request_id = f"q{self._next_id}"
            self._next_id += 1
        req: dict = {"op": op, "id": request_id, field: items}
        if flags:
            req["flags"] = dict(flags)
        if engine is not None:
            req["engine"] = engine
        if header:
            req["header"] = True
        if deadline_s is not None:
            req["deadline_s"] = float(deadline_s)
        protocol.send_frame(self._sock, req)
        hdr: list[str] = []
        sam: list[str] = []
        while True:
            frame = protocol.recv_frame(self._sock)
            if frame is None:
                raise ConnectionError("server closed the connection "
                                      "mid-response")
            kind = frame.get("type")
            if kind == "header":
                hdr.extend(frame["lines"])
            elif kind == "sam":
                sam.extend(frame["lines"])
            elif kind == "end":
                return ServeResult(id=request_id, header=hdr, sam=sam,
                                   n_records=int(frame["n_records"]))
            elif kind == "error":
                raise ServeError(frame.get("code", protocol.ERR_INTERNAL),
                                 frame.get("message", ""))
            else:
                raise protocol.ProtocolError(f"unexpected frame {kind!r}")
