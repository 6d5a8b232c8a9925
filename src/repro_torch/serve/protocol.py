"""Wire protocol of the alignment service: length-prefixed JSON frames
(a copy of ``repro.serve.protocol``: a client of either package talks to
a server of either package).

Every frame is a 4-byte big-endian payload length followed by that many
bytes of UTF-8 JSON — trivially parseable from any language, and framing
survives partial reads because both sides loop until the declared length
arrives.

Requests (client -> server), one JSON object per frame::

    {"op": "align",       "id": "r1", "reads": [["name", "ACGT..."], ...],
     "flags": {"-T": 25, "-R": "@RG\\tID:s1"},   # optional, bwa spellings
     "engine": "cuda",                            # optional override
     "header": true,                              # want @SQ/@RG lines
     "deadline_s": 5.0}                           # optional timeout
    {"op": "align_pairs", "id": "p1", "pairs": [["name", "SEQ1", "SEQ2"], ...],
     ...same optional fields...}
    {"op": "ping"}

Responses (server -> client); one request yields a *stream* of frames,
terminated by exactly one ``end`` or ``error``::

    {"type": "header", "id": ..., "lines": ["@SQ\\t...", ...]}
    {"type": "sam",    "id": ..., "lines": ["read0\\t0\\t...", ...]}
    {"type": "end",    "id": ..., "n_records": 3}
    {"type": "error",  "id": ..., "code": "deadline", "message": "..."}
    {"type": "pong",   ...server info...}

The SAM lines across the ``header``+``sam`` frames of one request are
byte-identical to an offline ``Aligner.stream_sam`` run over the same
reads and options — that is the service's conformance contract, enforced
by tests/test_torch_serve*.py and ``chip_smoke.py``'s serve phase.
"""

from __future__ import annotations

import json
import struct

#: Frames above this are rejected (malformed or abusive input).
MAX_FRAME = 64 * 1024 * 1024

#: Structured error codes carried by ``error`` frames.
ERR_BAD_REQUEST = "bad_request"        # malformed op/fields/sequences
ERR_READ_TOO_LONG = "read_too_long"    # read exceeds the server's cap
ERR_OVERLOADED = "overloaded"          # bounded queue full (backpressure)
ERR_DEADLINE = "deadline"              # per-request deadline exceeded
ERR_SHUTDOWN = "shutting_down"         # server no longer accepts work
ERR_INTERNAL = "internal"              # engine failure (bug — see runlog)

_LEN = struct.Struct(">I")


class ProtocolError(Exception):
    """Framing-level violation (bad length prefix, oversized frame)."""


def send_frame(sock, obj: dict) -> None:
    """Serialize ``obj`` and write one length-prefixed frame."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock) -> dict | None:
    """Read one frame; ``None`` on clean EOF before a length prefix."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ProtocolError("connection closed mid-frame")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame: {e}")
    if not isinstance(obj, dict):
        raise ProtocolError(f"frame is not a JSON object: {type(obj)}")
    return obj


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else _short(buf, n)
        buf += chunk
    return buf


def _short(buf: bytes, n: int) -> bytes | None:
    raise ProtocolError(f"connection closed after {len(buf)}/{n} bytes")
