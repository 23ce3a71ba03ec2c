"""Sink protocol — the delivery layer's single abstraction.

Every downstream surface (document indexing, alert distribution, token
packing) implements one contract:

  emit(batch)   deliver a list of records; a record is opaque to the
                layer (document sinks use ``(doc_id, doc)`` pairs,
                alert sinks use ``Alert`` objects)
  flush()       force out anything buffered
  close()       flush + release resources; further emits raise

plus per-sink observability baked into the base class: ``counters``
(emitted/batches/errors/retried/dead_lettered/flushes) and ``health()``
(healthy flag, consecutive failures, last error).  Wrappers
(``repro.delivery.wrappers``, ``repro.delivery.dispatch``) compose
behaviour — batching, retry with backoff, fan-out, per-backend
dispatcher threads — without the terminal sinks knowing.

Virtual time enters through ``tick(now)``: pass-through on terminal
sinks, the flush/backoff driver on wrappers.  The pipeline calls it
once per step, so time-based behaviour replays deterministically under
the virtual clock.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence


class SinkClosedError(RuntimeError):
    """Raised when a record is emitted into a closed sink."""


@dataclass
class SinkCounters:
    emitted: int = 0          # records accepted by this sink
    batches: int = 0          # emit() calls that succeeded
    errors: int = 0           # emit() calls that raised
    retried: int = 0          # re-delivery attempts (RetryingSink)
    dead_lettered: int = 0    # records given up on (routed to DLQ)
    flushes: int = 0

    def as_dict(self) -> dict:
        return {"emitted": self.emitted, "batches": self.batches,
                "errors": self.errors, "retried": self.retried,
                "dead_lettered": self.dead_lettered,
                "flushes": self.flushes}


class Sink:
    """Base class: subclasses implement ``_write(batch)``; ``emit`` adds
    the shared counter/health accounting and the closed-sink guard."""

    #: consecutive _write failures before ``healthy`` turns False
    unhealthy_after: int = 3

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.counters = SinkCounters()
        self.closed = False
        self.last_error: Optional[str] = None
        self.consecutive_failures = 0
        self._lock = threading.Lock()

    # ---- the protocol -----------------------------------------------------
    def emit(self, batch: Sequence) -> None:
        if self.closed:
            raise SinkClosedError(f"sink {self.name!r} is closed")
        batch = list(batch)
        if not batch:
            return
        try:
            self._write(batch)
        except Exception as e:
            with self._lock:
                self.counters.errors += 1
                self.consecutive_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
            raise
        with self._lock:
            self.counters.emitted += len(batch)
            self.counters.batches += 1
            self.consecutive_failures = 0
            self.last_error = None

    def _write(self, batch: List) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        self.counters.flushes += 1

    def tick(self, now: float) -> None:
        """Advance the sink's virtual clock (wrappers use it for delayed
        flushes and retry backoff; terminal sinks ignore it)."""

    def close(self) -> None:
        if self.closed:
            return
        self.flush()
        self.closed = True

    # ---- context manager (flush-on-close for free) ------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---- observability ----------------------------------------------------
    @property
    def terminal(self) -> "Sink":
        """The deepest wrapped sink (self for terminal sinks): wrappers
        expose an ``inner`` attribute, and acceptance at the terminal is
        what delivery lag is measured against."""
        inner = getattr(self, "inner", None)
        return self if inner is None else inner.terminal

    @property
    def healthy(self) -> bool:
        return self.consecutive_failures < self.unhealthy_after

    def health(self) -> dict:
        return {"healthy": self.healthy,
                "consecutive_failures": self.consecutive_failures,
                "last_error": self.last_error}

    def stats(self) -> dict:
        return {"name": self.name, **self.counters.as_dict(),
                **self.health()}


class CollectingSink(Sink):
    """In-memory terminal sink — tests/benchmarks and the simplest
    fan-out backend.  Keeps every record in arrival order."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.records: List = []

    def _write(self, batch: List) -> None:
        self.records.extend(batch)

    def __len__(self) -> int:
        return len(self.records)


class LegacySinkAdapter(Sink):
    """Wraps a pre-delivery document sink (anything exposing
    ``index(doc_id, doc)``) so it can sit behind the Sink protocol
    during the one-release migration window."""

    def __init__(self, legacy, name: Optional[str] = None):
        super().__init__(name or f"legacy:{type(legacy).__name__}")
        self.legacy = legacy

    def _write(self, batch: List) -> None:
        for doc_id, doc in batch:
            self.legacy.index(doc_id, doc)

    def flush(self) -> None:
        super().flush()
        fn = getattr(self.legacy, "flush", None)
        if callable(fn):
            fn()

    def close(self) -> None:
        if self.closed:
            return
        super().close()
        fn = getattr(self.legacy, "close", None)
        if callable(fn):
            fn()


def as_sink(obj) -> Sink:
    """Coerce a backend onto the Sink protocol: Sinks pass through,
    legacy ``index()``-only objects get adapted."""
    if isinstance(obj, Sink):
        return obj
    if callable(getattr(obj, "index", None)):
        return LegacySinkAdapter(obj)
    raise TypeError(
        f"{type(obj).__name__} is neither a repro_torch.delivery.Sink nor a "
        f"legacy index(doc_id, doc) sink")
