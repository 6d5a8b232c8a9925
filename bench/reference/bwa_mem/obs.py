"""The reference's telemetry: every span is a no-op, and counters land
only inside a ``counting()`` scope, which the benchmark's work counts
open (the banded BSW cells of ``bsw.bsw_row_step``)."""

from __future__ import annotations

import contextlib
import threading

_TLS = threading.local()


class Snapshot(dict):
    """A dict of stats that merges by adding numbers."""

    def merge_in(self, other) -> "Snapshot":
        for k, v in dict(other).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self[k] = self.get(k, 0) + v
            else:
                self[k] = v
        return self

    @classmethod
    def merge_all(cls, snaps) -> "Snapshot":
        out = cls()
        for s in snaps:
            out.merge_in(s)
        return out


def enabled() -> bool:
    return getattr(_TLS, "counts", None) is not None


def count(name: str, n=1) -> None:
    counts = getattr(_TLS, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + n


def observe(name: str, value, edges=None) -> None:
    pass


def span(name: str, cat: str = "stage", **args):
    return contextlib.nullcontext()


@contextlib.contextmanager
def counting():
    """Collect ``count`` calls of the calling thread into a dict."""
    prev = getattr(_TLS, "counts", None)
    _TLS.counts = {}
    try:
        yield _TLS.counts
    finally:
        _TLS.counts = prev
