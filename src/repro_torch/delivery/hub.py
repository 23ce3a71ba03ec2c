"""SubscriptionHub — the delivery layer's push surface.

Alerts (or any records) emitted into the hub are pushed to every
subscriber immediately; consumers stop polling.  Two consumption modes:

  callback   subscribe(callback=fn) — fn(record) runs synchronously at
             emit time; a raising callback is counted, never propagated
             (a broken consumer cannot take down the rule engine)
  iterator   subscribe() — a Subscription with per-key bounded buffers;
             iterate or drain() at leisure.  Backpressure is non-
             blocking: when a key's buffer is full the OLDEST record is
             dropped and counted, so a slow subscriber loses its own
             tail instead of stalling the producer, and one noisy rule
             cannot evict another rule's records (per-rule isolation —
             the default key is the record's ``rule`` attribute).

Long-poll: ``Subscription.wait(timeout)`` blocks (condition variable,
no spinning) until the next record or the timeout; ``hub.wait(timeout)``
is the one-shot form — the blocking-GET primitive a remote serving
client needs to wait on the next alert.

Asyncio: an iterator-mode ``Subscription`` is also an async iterator
(``async for rec in sub``), and ``hub.async_iter(rule)`` filters one
rule's records — both are event-driven bridges over the same buffers
(``loop.call_soon_threadsafe`` wakes the consumer), so a thousand
dashboard subscribers cost a thousand coroutines, not a thousand
threads.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.delivery.base import Sink


def _default_key(record) -> str:
    return str(getattr(record, "rule", "_"))


class Subscription:
    """One consumer's view of a hub: bounded per-key buffers + counters.
    Iterating yields (and removes) currently buffered records."""

    def __init__(self, hub: "SubscriptionHub",
                 callback: Optional[Callable] = None, *,
                 capacity: int = 256,
                 key_fn: Optional[Callable[[object], str]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.hub = hub
        self.callback = callback
        self.capacity = capacity
        self.key_fn = key_fn or _default_key
        self.delivered = 0
        self.errors = 0
        self.dropped: Dict[str, int] = collections.defaultdict(int)
        self.closed = False
        self._buffers: Dict[str, collections.deque] = {}
        self._order: collections.deque = collections.deque()  # arrival keys
        # a Condition so wait() can block for the next push; `with` takes
        # the underlying lock, keeping every existing critical section
        self._lock = threading.Condition()
        # asyncio bridge (bound lazily by the first __anext__): the
        # producer thread wakes the consumer's event loop with
        # call_soon_threadsafe — one coroutine per subscriber, no thread
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._aio_event: Optional[asyncio.Event] = None

    # ---- producer side (hub only) -----------------------------------------
    def _push(self, record) -> None:
        if self.closed:
            return
        if self.callback is not None:
            try:
                self.callback(record)
            except Exception:
                self.errors += 1
            else:
                self.delivered += 1
            return
        key = self.key_fn(record)
        with self._lock:
            buf = self._buffers.get(key)
            if buf is None:
                buf = self._buffers[key] = collections.deque()
            if len(buf) >= self.capacity:      # bounded: drop this key's
                buf.popleft()                  # oldest, never block
                self.dropped[key] += 1
                # the dropped record held this key's EARLIEST arrival
                # slot; retire that slot so cross-key order stays true
                # (the new record queues at the back like any arrival)
                try:
                    self._order.remove(key)
                except ValueError:
                    pass
            buf.append(record)
            self._order.append(key)
            self.delivered += 1
            self._lock.notify_all()      # wake long-poll waiters
            self._signal_async()         # ...and async iterators

    # ---- consumer side -----------------------------------------------------
    def pop(self):
        """Oldest buffered record across keys (arrival order), or None."""
        with self._lock:
            while self._order:
                key = self._order.popleft()
                buf = self._buffers.get(key)
                if buf:
                    return buf.popleft()
            return None

    def wait(self, timeout: Optional[float] = None):
        """Long-poll: return the next record in arrival order, blocking
        up to ``timeout`` seconds (wall clock; None = forever) for one
        to arrive.  Returns None on timeout or if the subscription is
        closed while waiting.  No spinning — a condition variable parks
        the caller until the producer's next push."""
        if self.callback is not None:
            raise RuntimeError(
                "wait() requires an iterator-mode subscription "
                "(subscribe() without a callback)")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:                 # Condition wraps an RLock, so
            while True:                  # pop() re-enters it safely
                rec = self.pop()
                if rec is not None:
                    return rec
                if self.closed:
                    return None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._lock.wait(remaining)

    def drain(self, max_items: Optional[int] = None) -> List:
        out: List = []
        while max_items is None or len(out) < max_items:
            rec = self.pop()
            if rec is None:
                break
            out.append(rec)
        return out

    def __iter__(self):
        while True:
            rec = self.pop()
            if rec is None:
                return
            yield rec

    # ---- asyncio bridge ----------------------------------------------------
    def _signal_async(self) -> None:
        """Wake the async consumer (if any) from the producer thread.
        Called with self._lock held; call_soon_threadsafe is the only
        loop API that is safe from a foreign thread."""
        loop, event = self._aio_loop, self._aio_event
        if loop is not None and event is not None:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass                     # consumer's loop already closed

    def __aiter__(self):
        return self

    async def __anext__(self):
        """Next record in arrival order, parking the coroutine (not a
        thread) until the producer pushes one.  Ends on close()."""
        if self.callback is not None:
            raise RuntimeError(
                "async iteration requires an iterator-mode subscription "
                "(subscribe() without a callback)")
        loop = asyncio.get_running_loop()
        with self._lock:
            if self._aio_loop is None:
                self._aio_loop = loop
                self._aio_event = asyncio.Event()
            elif self._aio_loop is not loop:
                raise RuntimeError(
                    "subscription already bound to another event loop")
            event = self._aio_event
        while True:
            # clear BEFORE pop: a push landing after the pop re-sets the
            # event, so the classic lost-wakeup race cannot park us with
            # a non-empty buffer
            event.clear()
            rec = self.pop()
            if rec is not None:
                return rec
            if self.closed:
                raise StopAsyncIteration
            await event.wait()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buffers.values())

    def dropped_total(self) -> int:
        return sum(self.dropped.values())

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._lock.notify_all()      # release long-poll waiters
            self._signal_async()         # ...and async iterators
        self.hub.unsubscribe(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class SubscriptionHub(Sink):
    """A Sink that pushes every emitted record to all subscribers."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name or "hub")
        self._subs: List[Subscription] = []
        self._subs_lock = threading.Lock()

    def subscribe(self, callback: Optional[Callable] = None, *,
                  capacity: int = 256,
                  key_fn: Optional[Callable[[object], str]] = None
                  ) -> Subscription:
        sub = Subscription(self, callback, capacity=capacity, key_fn=key_fn)
        with self._subs_lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._subs_lock:
            if sub in self._subs:
                self._subs.remove(sub)

    @property
    def subscriber_count(self) -> int:
        with self._subs_lock:
            return len(self._subs)

    def wait(self, timeout: Optional[float] = None):
        """One-shot long-poll: block until the NEXT record emitted into
        the hub (or ``timeout`` seconds; None = forever) and return it,
        or None on timeout.  An ephemeral iterator-mode subscription is
        registered for the duration and always removed — the blocking
        primitive a remote serving client uses to wait on the next alert
        without spinning."""
        with self.subscribe(capacity=1) as sub:
            return sub.wait(timeout)

    async def async_iter(self, rule: Optional[str] = None, *,
                         capacity: int = 256,
                         key_fn: Optional[Callable[[object], str]] = None):
        """``async for rec in hub.async_iter("volume_spike")`` — an
        event-driven stream of this hub's records, optionally filtered
        to one rule name.  Subscribes on entry, unsubscribes when the
        consumer stops iterating; no thread per subscriber (the test
        suite pins that)."""
        sub = self.subscribe(capacity=capacity, key_fn=key_fn)
        try:
            async for rec in sub:
                if rule is None or str(getattr(rec, "rule", "_")) == rule:
                    yield rec
        finally:
            sub.close()

    def _write(self, batch: List) -> None:
        with self._subs_lock:
            subs = list(self._subs)
        for record in batch:
            for sub in subs:
                sub._push(record)

    def stats(self) -> dict:
        base = super().stats()
        with self._subs_lock:
            subs = list(self._subs)
        base["subscribers"] = len(subs)
        base["dropped"] = sum(s.dropped_total() for s in subs)
        return base
