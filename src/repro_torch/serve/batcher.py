"""Continuous-batching request queue for the alignment service (a copy
of ``repro.serve.batcher``; ``AlignOptions`` is the port's).

The paper's speedup comes from keeping the hot kernels saturated with
large contiguous batches; individual service requests are small.  The
``RequestQueue`` bridges the two: client connections enqueue
``Request``s (bounded — a full queue raises :class:`Overloaded`, the
backpressure signal), and the scheduler thread dequeues the OLDEST
request then *coalesces* every other queued request from the same
**cohort** into one engine batch, up to a read budget.

A cohort is the compatibility class for sharing a padded batch::

    (op, AlignOptions, engine_override)

``AlignOptions`` is frozen/hashable, so identical option sets — however
they were spelled — land in one cohort.  SE requests from one cohort are
always safe to coalesce: per-read output is batch-composition-
independent (the facade regroups by true length).  PE requests are only
coalesced when the server holds frozen insert-size stats; otherwise each
PE request runs as its own engine batch, exactly matching the offline
single-batch run (per-batch ``mem_pestat`` makes PE output depend on
batch composition).  That decision lives in the server; the queue just
honors the cohort key it is given.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

from ..options import AlignOptions


class Overloaded(Exception):
    """Bounded queue full — reject the request (backpressure)."""


class QueueClosed(Exception):
    """Queue closed and drained; the scheduler should exit."""


@dataclasses.dataclass
class Request:
    """One parsed client request, queued for the scheduler."""
    id: str
    op: str                       # "align" | "align_pairs"
    names: list
    seqs: list                    # SE: [seq, ...]; PE: [(s1, s2), ...]
    options: AlignOptions
    engine: str | None
    header: bool
    deadline: float | None        # absolute time.monotonic() deadline
    conn: Any                     # _Conn owning the response stream
    received: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def n_reads(self) -> int:
        return len(self.seqs) * (2 if self.op == "align_pairs" else 1)

    def cohort_key(self, coalesce_pe: bool) -> tuple:
        """Batch-compatibility key; a non-coalescable PE request gets a
        unique key (its own id) so it never shares an engine batch."""
        if self.op == "align_pairs" and not coalesce_pe:
            return (self.op, self.options, self.engine, self.id, id(self))
        return (self.op, self.options, self.engine)

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None and
                (time.monotonic() if now is None else now) > self.deadline)


class RequestQueue:
    """Bounded FIFO with cohort extraction, safe across N conn threads
    and one scheduler thread."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._items: collections.deque[Request] = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def put(self, req: Request) -> None:
        with self._lock:
            if self._closed:
                raise QueueClosed()
            if len(self._items) >= self.maxsize:
                raise Overloaded(f"queue full ({self.maxsize} requests)")
            self._items.append(req)
            self._nonempty.notify()

    def get(self, timeout: float | None = None) -> Request:
        """Oldest request; blocks.  Raises QueueClosed once closed AND
        drained — close() lets already-queued work finish (drain-on-
        shutdown)."""
        with self._lock:
            # the loop re-checks after every wakeup: spurious wakeups,
            # close() notifications and the 0.5s poll all land here
            while not self._items:
                if self._closed:
                    raise QueueClosed()
                if not self._nonempty.wait(timeout=timeout or 0.5):
                    if timeout is not None:
                        raise TimeoutError()
            return self._items.popleft()

    def take_cohort(self, key: tuple, coalesce_pe: bool,
                    budget_reads: int) -> list[Request]:
        """Remove and return queued requests whose cohort matches ``key``
        (FIFO order), stopping once their summed reads exceed the budget.
        Non-matching requests keep their positions."""
        taken: list[Request] = []
        total = 0
        with self._lock:
            kept: collections.deque[Request] = collections.deque()
            while self._items:
                r = self._items.popleft()
                if total < budget_reads and r.cohort_key(coalesce_pe) == key:
                    taken.append(r)
                    total += r.n_reads
                else:
                    kept.append(r)
            self._items = kept
        return taken

    def close(self) -> None:
        """Stop accepting; wake the scheduler so it drains and exits."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
