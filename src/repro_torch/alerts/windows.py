"""Event-time windowed aggregation with watermarks (the analytics stage
AlertMix needs downstream of ingestion: Kejariwal et al. identify windowed
aggregation + watermarks as the primitive separating a streaming platform
from fast batch).

``WindowOperator`` assigns events to tumbling / sliding / session windows
keyed by an arbitrary key (here: channel or source id), keeps one
incremental accumulator per (key, window) — count / sum / sum-of-squares /
max, enough to derive mean and variance without buffering events — and
closes windows as a *monotonic* watermark passes ``window_end +
allowed_lateness``.

Late events (event_time older than ``watermark - allowed_lateness``) can
never belong to a still-open window, so they are routed to the existing
``DeadLettersListener`` under reason ``"late_event"`` instead of mutating
closed state.  Because accumulator state is deleted at close and the
lateness rule is the exact complement of the close rule, every window is
emitted exactly once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

TUMBLING = "tumbling"
SLIDING = "sliding"
SESSION = "session"


@dataclass(frozen=True)
class WindowSpec:
    """Window assignment policy.

    tumbling: fixed, non-overlapping ``[k*size, (k+1)*size)`` buckets.
    sliding:  overlapping buckets of ``size`` every ``slide`` seconds.
    session:  per-key activity windows closed after ``gap`` idle seconds.
    """

    kind: str = TUMBLING
    size_s: float = 60.0
    slide_s: Optional[float] = None      # sliding only; defaults to size/2
    gap_s: float = 30.0                  # session only
    allowed_lateness_s: float = 0.0

    def __post_init__(self):
        if self.kind not in (TUMBLING, SLIDING, SESSION):
            raise ValueError(f"unknown window kind: {self.kind!r}")
        if self.size_s <= 0 or (self.kind == SESSION and self.gap_s <= 0):
            raise ValueError("window size/gap must be positive")
        if self.kind == SLIDING:
            if self.slide_s is None:
                object.__setattr__(self, "slide_s", self.size_s / 2.0)
            # slide > size would leave gaps where events fall into NO
            # window and silently vanish from every aggregate
            if not 0 < self.slide_s <= self.size_s:
                raise ValueError(
                    f"slide_s must be in (0, size_s]; got slide_s="
                    f"{self.slide_s}, size_s={self.size_s}")

    def assign(self, t: float) -> List[Tuple[float, float]]:
        """Window [start, end) intervals containing event-time ``t``
        (tumbling/sliding only — session windows are data-driven)."""
        if self.kind == TUMBLING:
            start = math.floor(t / self.size_s) * self.size_s
            return [(start, start + self.size_s)]
        if self.kind == SLIDING:
            slide = float(self.slide_s)
            last = math.floor(t / slide) * slide
            out = []
            start = last
            while start > t - self.size_s:
                out.append((start, start + self.size_s))
                start -= slide
            return out
        raise ValueError("session windows are assigned incrementally")


@dataclass
class WindowAggregate:
    """Closed-form accumulator for one (key, window) — mergeable, so the
    same shape serves sessions (merge on overlap) and the window_reduce
    segment reduction (count/sum/sumsq/max lanes)."""

    key: str
    window_start: float
    window_end: float
    count: int = 0
    sum: float = 0.0
    sumsq: float = 0.0
    max: float = float("-inf")
    first_seen_at: float = 0.0           # processing (virtual) time
    closed_at_watermark: float = 0.0     # stamped at close
    # declared last so older positional constructions stay valid
    min: float = float("inf")

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def variance(self) -> float:
        if self.count < 2:
            return 0.0
        return max(0.0, self.sumsq / self.count - self.mean ** 2)

    def add(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.sumsq += value * value
        if value > self.max:
            self.max = value
        if value < self.min:
            self.min = value

    def merge(self, other: "WindowAggregate") -> None:
        self.window_start = min(self.window_start, other.window_start)
        self.window_end = max(self.window_end, other.window_end)
        self.count += other.count
        self.sum += other.sum
        self.sumsq += other.sumsq
        self.max = max(self.max, other.max)
        self.min = min(self.min, other.min)
        self.first_seen_at = min(self.first_seen_at, other.first_seen_at)


class WindowOperator:
    """Per-key event-time windowing with a monotonic watermark.

    The watermark advances two ways: bounded out-of-orderness from observed
    event times (``max_event_time - watermark_lag_s``) and explicit
    ``advance_watermark`` ticks from the pipeline's virtual clock, so quiet
    keys still close.  It never regresses.
    """

    def __init__(self, spec: WindowSpec, *, watermark_lag_s: float = 0.0,
                 dead_letters=None):
        self.spec = spec
        self.watermark_lag_s = watermark_lag_s
        self.dead_letters = dead_letters
        self.watermark = float("-inf")
        self._max_event_time = float("-inf")
        # (key, start, end) -> aggregate for tumbling/sliding;
        # key -> sorted session list for session windows
        self._state: Dict[Tuple[str, float, float], WindowAggregate] = {}
        self._sessions: Dict[str, List[WindowAggregate]] = {}
        self.stats = {"events": 0, "late_dropped": 0, "windows_closed": 0}

    # ---- ingestion ---------------------------------------------------------

    def observe(self, key: str, event_time: float, value: float = 1.0,
                *, now: float = 0.0) -> bool:
        """Fold one event in.  Returns False (and dead-letters the event)
        when it is too late to belong to any open window."""
        self.stats["events"] += 1
        if event_time < self.watermark - self.spec.allowed_lateness_s:
            self.stats["late_dropped"] += 1
            if self.dead_letters is not None:
                self.dead_letters.publish(
                    {"key": key, "event_time": event_time, "value": value,
                     "watermark": self.watermark},
                    reason="late_event")
            return False
        if event_time > self._max_event_time:
            self._max_event_time = event_time

        if self.spec.kind == SESSION:
            self._observe_session(key, event_time, value, now)
        else:
            for start, end in self.spec.assign(event_time):
                slot = (key, start, end)
                agg = self._state.get(slot)
                if agg is None:
                    agg = self._state[slot] = WindowAggregate(
                        key=key, window_start=start, window_end=end,
                        first_seen_at=now)
                agg.add(value)
        return True

    def _observe_session(self, key: str, t: float, value: float,
                         now: float) -> None:
        gap = self.spec.gap_s
        sessions = self._sessions.setdefault(key, [])
        new = WindowAggregate(key=key, window_start=t, window_end=t + gap,
                              first_seen_at=now)
        new.add(value)
        merged: List[WindowAggregate] = []
        for s in sessions:
            # overlap in [start, end) extended-by-gap terms
            if s.window_end >= new.window_start and new.window_end >= s.window_start:
                new.merge(s)
            else:
                merged.append(s)
        merged.append(new)
        merged.sort(key=lambda s: s.window_start)
        self._sessions[key] = merged

    # ---- watermark + close -------------------------------------------------

    def advance_watermark(self, t: float) -> float:
        """Raise the watermark to max(observed-lag, t-lag); monotonic."""
        candidate = max(self._max_event_time, t) - self.watermark_lag_s
        if candidate > self.watermark:
            self.watermark = candidate
        return self.watermark

    def poll_closed(self) -> List[WindowAggregate]:
        """Emit every window with ``end + lateness <= watermark`` exactly
        once (state is deleted on emission; later events for the same
        window are late by construction and never resurrect it)."""
        horizon = self.watermark - self.spec.allowed_lateness_s
        closed: List[WindowAggregate] = []
        if self.spec.kind == SESSION:
            for key, sessions in self._sessions.items():
                still_open = []
                for s in sessions:
                    if s.window_end <= horizon:
                        closed.append(s)
                    else:
                        still_open.append(s)
                self._sessions[key] = still_open
        else:
            done = [slot for slot in self._state if slot[2] <= horizon]
            for slot in done:
                closed.append(self._state.pop(slot))
        for agg in closed:
            agg.closed_at_watermark = self.watermark
        self.stats["windows_closed"] += len(closed)
        closed.sort(key=lambda a: (a.window_end, a.key))
        return closed

    def open_windows(self) -> int:
        return len(self._state) + sum(len(v) for v in self._sessions.values())
