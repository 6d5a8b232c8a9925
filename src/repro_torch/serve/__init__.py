"""Always-on alignment service of the port: persistent server + continuous
batching, over the port's ``Aligner`` and its hand-written kernels.

The paper's kernels win by staying saturated with large batches; service
traffic arrives as many small requests.  This package bridges the two,
as ``repro.serve`` does for the reference:

* ``server.AlignmentServer`` — loads the FM-index once, coalesces queued
  requests of one option-cohort into full-width padded engine batches on
  ``options.device`` (the card by default), and streams each request's
  SAM records back byte-identical to an offline ``Aligner.stream_sam``
  run (the conformance contract).
* ``client.ServeClient`` — thin blocking client over the wire protocol.
* ``protocol`` — length-prefixed JSON frames + structured error codes,
  the same as the reference's: a client of either package talks to a
  server of either package.
* ``batcher`` — the bounded request queue and cohort coalescing rules.

Front-end: ``python -m repro_torch.cli serve ref.fa [--port P]
[--device cuda|cpu] [...]``.
"""

from .batcher import Overloaded, QueueClosed, Request, RequestQueue
from .client import ServeClient, ServeError, ServeResult
from .protocol import (ERR_BAD_REQUEST, ERR_DEADLINE, ERR_INTERNAL,
                       ERR_OVERLOADED, ERR_READ_TOO_LONG, ERR_SHUTDOWN,
                       MAX_FRAME, ProtocolError, recv_frame, send_frame)
from .server import MAX_READ_LEN, AlignmentServer

__all__ = [
    "AlignmentServer", "MAX_READ_LEN",
    "ServeClient", "ServeError", "ServeResult",
    "Request", "RequestQueue", "Overloaded", "QueueClosed",
    "ProtocolError", "send_frame", "recv_frame", "MAX_FRAME",
    "ERR_BAD_REQUEST", "ERR_READ_TOO_LONG", "ERR_OVERLOADED",
    "ERR_DEADLINE", "ERR_SHUTDOWN", "ERR_INTERNAL",
]
