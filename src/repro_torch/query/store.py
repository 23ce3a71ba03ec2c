"""Materialized aggregate segments — the hot half of the query plane.

``MaterializedStore`` continuously folds closed ``WindowAggregate``
records (from the live ``AnalyticsStage`` export hook, or from batch
replay) into per-(key, window) segments holding the same closed-form
lanes the window_reduce kernel produces — count / sum / sumsq / min / max —
from which every supported aggregate (mean, stddev, rate, ...) derives.
This is the Pinot-style serving shape: queries never touch raw events
while the range they ask about is *hot*.

Retention is per key: beyond ``max_windows_per_key`` the oldest windows
are evicted and the store's ``floor`` rises to the newest evicted
window-end.  Ranges below the floor are *cold* — ``QueryEngine`` answers
them by replaying the durable EventLog through the batch kernel path
instead (see engine.py), so eviction trades memory for query latency,
never for correctness.

Thread-safety: ingest happens on the pipeline thread, lookups on any
caller thread; one lock guards the maps.  Listeners (the asyncio watch
surface) are invoked *outside* the lock and must be cheap — the plane
wires ``loop.call_soon_threadsafe(event.set)`` there.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.alerts.windows import WindowAggregate

SegmentRow = Tuple[float, float, int, float, float, float, float]
# (start, end, count, sum, sumsq, min, max) — a value snapshot, safe to
# read without holding the store lock


@dataclass
class _Segment:
    start: float
    end: float
    count: int = 0
    sum: float = 0.0
    sumsq: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def fold(self, agg: WindowAggregate) -> None:
        self.count += agg.count
        self.sum += agg.sum
        self.sumsq += agg.sumsq
        if agg.min < self.min:
            self.min = agg.min
        if agg.max > self.max:
            self.max = agg.max

    def row(self) -> SegmentRow:
        return (self.start, self.end, self.count, self.sum, self.sumsq,
                self.min, self.max)


class _KeyShard:
    """Segments for one key, sorted by (start, end) for bisect pruning."""

    __slots__ = ("order", "segs", "max_extent")

    def __init__(self):
        self.order: List[Tuple[float, float]] = []   # (start, end) keys
        self.segs: List[_Segment] = []               # aligned with order
        self.max_extent = 0.0                        # widest window seen


class MaterializedStore:
    """Per-(key, window) aggregate segments with time/key-pruned lookup.

    ``on_advance(closed, watermark)`` is the ``AnalyticsStage`` export
    hook: it merges each closed window into its slot (late replays merge
    rather than duplicate) and advances the serving watermark.  Every
    state change bumps ``version`` — the (watermark, version) pair is
    the query cache's invalidation token.
    """

    def __init__(self, *, max_windows_per_key: int = 4096):
        if max_windows_per_key < 1:
            raise ValueError("max_windows_per_key must be >= 1")
        self.max_windows_per_key = max_windows_per_key
        self._lock = threading.Lock()
        self._keys: Dict[str, _KeyShard] = {}
        self._slots: Dict[Tuple[str, float, float], _Segment] = {}
        self.watermark = float("-inf")
        self.version = 0
        # everything strictly before the floor may have been evicted;
        # cold queries go through the EventLog replay path instead
        self.floor = float("-inf")
        self.stats = {"ingested_windows": 0, "merged_windows": 0,
                      "evicted_windows": 0}
        self._listeners: List[Callable[[], None]] = []

    # ---- ingest (export hook) ---------------------------------------------

    def on_advance(self, closed: Sequence[WindowAggregate],
                   watermark: float) -> None:
        notify = False
        with self._lock:
            for agg in closed:
                self._ingest(agg)
            if closed:
                self.version += 1
                notify = True
            if watermark > self.watermark:
                self.watermark = watermark
                notify = True
        if notify:
            for fn in list(self._listeners):
                fn()

    def _ingest(self, agg: WindowAggregate) -> None:
        slot = (agg.key, agg.window_start, agg.window_end)
        seg = self._slots.get(slot)
        if seg is not None:
            # a late/replayed re-close of an already-materialized window
            seg.fold(agg)
            self.stats["merged_windows"] += 1
            return
        shard = self._keys.get(agg.key)
        if shard is None:
            shard = self._keys[agg.key] = _KeyShard()
        seg = _Segment(start=agg.window_start, end=agg.window_end)
        seg.fold(agg)
        order_key = (seg.start, seg.end)
        i = bisect.bisect_left(shard.order, order_key)
        shard.order.insert(i, order_key)
        shard.segs.insert(i, seg)
        extent = seg.end - seg.start
        if extent > shard.max_extent:
            shard.max_extent = extent
        self._slots[slot] = seg
        self.stats["ingested_windows"] += 1
        while len(shard.segs) > self.max_windows_per_key:
            old_key = shard.order.pop(0)
            old = shard.segs.pop(0)
            del self._slots[(agg.key, old_key[0], old_key[1])]
            if old.end > self.floor:
                self.floor = old.end
            self.stats["evicted_windows"] += 1

    # ---- lookup ------------------------------------------------------------

    def lookup(self, keys: Sequence[str], start: float,
               end: float) -> Dict[str, List[SegmentRow]]:
        """Value-snapshot rows for every hot segment overlapping
        ``[start, end)`` per key, pruned by bisect on window start."""
        out: Dict[str, List[SegmentRow]] = {}
        with self._lock:
            for key in keys:
                shard = self._keys.get(key)
                if shard is None:
                    continue
                # leftmost candidate: a window overlapping [start, end)
                # must begin after start - max_extent
                lo = bisect.bisect_left(shard.order,
                                        (start - shard.max_extent,))
                rows: List[SegmentRow] = []
                for seg in shard.segs[lo:]:
                    if seg.start >= end:
                        break
                    if seg.end > start:
                        rows.append(seg.row())
                if rows:
                    out[key] = rows
        return out

    def hot_slots(self, keys: Sequence[str], start: float,
                  end: float) -> set:
        """(key, start, end) slot ids currently materialized in the
        range — the engine uses this to dedupe hot vs cold results."""
        found = set()
        for key, rows in self.lookup(keys, start, end).items():
            for row in rows:
                found.add((key, row[0], row[1]))
        return found

    # ---- watch / status ----------------------------------------------------

    def add_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def status(self) -> dict:
        with self._lock:
            return {"hot_segments": len(self._slots),
                    "hot_keys": len(self._keys),
                    "watermark": self.watermark,
                    "version": self.version,
                    "floor": self.floor,
                    **self.stats}
