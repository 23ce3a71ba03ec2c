"""StageProfiler — always-on wall-clock timers for named pipeline stages.

Built for ROADMAP item 1: the batch-replay chain (``pack_events`` ->
decode -> kernel launch -> state merge) is 266x slower than the
incremental live path, and nobody could say which stage eats the time.
A profiler instance rides the component that owns the chain (the
ReplayEngine), each stage is wrapped in ``with profiler.stage(name):``,
and ``snapshot()`` reports per-stage call counts, total/mean/max
milliseconds, and each stage's share of the profiled total — the
breakdown ``replay_status()`` and ``bench_store`` surface.

Cost per stage entry is two ``perf_counter`` calls and one locked
accumulate, so it stays on in production paths.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class _Stage:
    __slots__ = ("calls", "total_s", "max_s", "last_s")

    def __init__(self):
        self.calls = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.last_s = 0.0


class _StageCtx:
    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "StageProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._prof._record(self._name, time.perf_counter() - self._t0)


class StageProfiler:
    def __init__(self, name: str = "profile"):
        self.name = name
        self._lock = threading.Lock()
        self._stages: Dict[str, _Stage] = {}

    def stage(self, name: str) -> _StageCtx:
        """Time one pass through stage ``name`` (context manager)."""
        return _StageCtx(self, name)

    def record(self, name: str, seconds: float) -> None:
        """Fold an externally-timed duration into stage ``name``."""
        self._record(name, seconds)

    def _record(self, name: str, dt: float) -> None:
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                st = self._stages[name] = _Stage()
            st.calls += 1
            st.total_s += dt
            st.last_s = dt
            if dt > st.max_s:
                st.max_s = dt

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()

    def snapshot(self) -> dict:
        """{stage: {calls, total_ms, mean_ms, max_ms, last_ms, share}}
        — ``share`` is the stage's fraction of the profiled total, the
        number that says where the replay gap lives."""
        with self._lock:
            total = sum(s.total_s for s in self._stages.values())
            out = {}
            for name, s in sorted(self._stages.items()):
                out[name] = {
                    "calls": s.calls,
                    "total_ms": s.total_s * 1e3,
                    "mean_ms": (s.total_s / s.calls) * 1e3 if s.calls else 0.0,
                    "max_ms": s.max_s * 1e3,
                    "last_ms": s.last_s * 1e3,
                    "share": (s.total_s / total) if total > 0 else 0.0,
                }
            return out
