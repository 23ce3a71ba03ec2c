"""repro_torch.alerts — event-time windowed analytics + alert-rule engine
(the port of ``repro.alerts``).

Ingested documents become *alerts*:

  WindowOperator   event-time tumbling/sliding/session windows per key,
                   monotonic watermark, allowed lateness, late events ->
                   DeadLettersListener        (windows.py)
  RuleEngine       threshold / rate-of-change / z-score rules over closed
                   WindowAggregates -> Alert -> AlertSink   (rules.py)
  window_reduce    Hopper kernel: batched per-(key, window) count/sum/
                   sumsq/max segment reductions for the batch path
                   (repro_torch.kernels.window_reduce, via batch.py)
  AnalyticsStage   the glue a pipeline mounts: observe
                   documents, advance the watermark off the virtual clock,
                   close windows, run rules          (this module)
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.alerts.rules import (
    Alert,
    AlertRule,
    AlertSink,
    RateOfChangeRule,
    RuleEngine,
    ThresholdRule,
    ZScoreRule,
)
from repro_torch.alerts.windows import (
    SESSION,
    SLIDING,
    TUMBLING,
    WindowAggregate,
    WindowOperator,
    WindowSpec,
)


class AnalyticsStage:
    """One-stop analytics stage: key extraction -> window operator ->
    rule engine (documents keyed by channel, value = 1 event, unless the
    extractors say otherwise)."""

    def __init__(self, spec: WindowSpec, rules: List[AlertRule], *,
                 key_fn: Optional[Callable[[dict], str]] = None,
                 value_fn: Optional[Callable[[dict], float]] = None,
                 time_fn: Optional[Callable[[dict], float]] = None,
                 watermark_lag_s: float = 0.0,
                 dead_letters=None,
                 alert_hook: Optional[Callable[[Alert], None]] = None,
                 alerts_keep_last: int = 10_000):
        self.operator = WindowOperator(
            spec, watermark_lag_s=watermark_lag_s, dead_letters=dead_letters)
        self.sink = AlertSink(hook=alert_hook, keep_last=alerts_keep_last)
        self.engine = RuleEngine(rules, sink=self.sink)
        self.key_fn = key_fn or (lambda doc: str(doc.get("channel", "all")))
        self.value_fn = value_fn or (lambda doc: 1.0)
        self.time_fn = time_fn or (lambda doc: float(doc["published_at"]))
        self.closed_total = 0
        # optional tracer (``span(name, attrs=...)`` context manager):
        # when set, rule evaluation over closed windows records a
        # rules.eval span
        self.tracer = None
        # export hooks: fn(closed_windows, watermark), called on EVERY
        # advance — even watermark-only ticks, so downstream consumers
        # (the repro_torch.query materialized store) track freshness without
        # waiting for the next window to close
        self._exports: List[Callable[[List[WindowAggregate], float], None]] = []

    def observe(self, doc: dict, *, now: float = 0.0) -> bool:
        return self.operator.observe(
            self.key_fn(doc), self.time_fn(doc), self.value_fn(doc), now=now)

    def add_export(self,
                   fn: Callable[[List[WindowAggregate], float], None]) -> None:
        """Register a closed-window export hook (e.g. a materialized
        store).  Hooks see every closed window exactly once plus every
        watermark advance (possibly with an empty window list)."""
        self._exports.append(fn)

    def export_closed(self, closed: List[WindowAggregate],
                      watermark: Optional[float] = None) -> None:
        """Feed ``closed`` windows to every export hook.  Also the entry
        point for batch/replay paths (repro_torch.store.ReplayEngine) whose
        aggregates bypass ``advance``."""
        wm = self.operator.watermark if watermark is None else watermark
        for fn in self._exports:
            fn(closed, wm)

    def advance(self, now: float) -> List[Alert]:
        """Advance the watermark to the pipeline's virtual clock, close
        due windows, and evaluate rules.  Returns newly fired alerts."""
        self.operator.advance_watermark(now)
        closed = self.operator.poll_closed()
        self.closed_total += len(closed)
        fired: List[Alert] = []
        if closed:
            if self.tracer is not None:
                with self.tracer.span("rules.eval",
                                      attrs={"windows": len(closed)}) as sp:
                    fired = self.engine.process(closed)
                    sp.set("alerts", len(fired))
            else:
                fired = self.engine.process(closed)
        if self._exports:
            self.export_closed(closed)
        return fired

    @property
    def alerts(self) -> List[Alert]:
        return self.sink.fired

    def snapshot(self) -> dict:
        return {"watermark": self.operator.watermark,
                "open_windows": self.operator.open_windows(),
                "windows_closed": self.closed_total,
                "operator": dict(self.operator.stats),
                "alerts": self.sink.snapshot()}


__all__ = [
    "Alert", "AlertRule", "AlertSink", "AnalyticsStage", "RateOfChangeRule",
    "RuleEngine", "SESSION", "SLIDING", "TUMBLING", "ThresholdRule",
    "WindowAggregate", "WindowOperator", "WindowSpec", "ZScoreRule",
]
