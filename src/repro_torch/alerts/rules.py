"""Declarative alert rules evaluated over closed window aggregates.

Three rule families cover the paper's alerting scenarios:

  ThresholdRule     metric crosses an absolute bound (volume spike, silence)
  RateOfChangeRule  metric jumps vs the previous window for the same key
  ZScoreRule        metric is anomalous vs the key's own history (Welford
                    running mean/variance over past windows)

``RuleEngine.process`` feeds every ``WindowAggregate`` through every rule
and publishes fired ``Alert`` records to an ``AlertSink``.  Rules are
stateful per (rule, key) but windows arrive exactly once (the operator's
contract), so rule history never double-counts.

``AlertSink`` keeps a bounded in-memory log of fired alerts with
per-rule totals, pushes each alert to a ``SubscriptionHub`` so consumers
stream alerts as they fire (``subscribe()``), and calls an optional hook
at emit time.  (The JAX package routes the log and the hub through a
``FanOutSink``; that wrapper arrives with the pipeline slice.)
"""
from __future__ import annotations

import operator
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.alerts.windows import WindowAggregate
from repro_torch.delivery import Subscription, SubscriptionHub

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt, ">=": operator.ge,
    "<": operator.lt, "<=": operator.le,
}

METRICS = ("count", "sum", "mean", "max", "min", "variance")


def _metric(agg: WindowAggregate, name: str) -> float:
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; choose from {METRICS}")
    return float(getattr(agg, name))


@dataclass
class Alert:
    rule: str
    key: str
    window_start: float
    window_end: float
    metric: str
    value: float
    message: str
    severity: str = "warning"
    fired_at_watermark: float = 0.0

    @property
    def watermark_to_alert_s(self) -> float:
        """Event-time lag from window close boundary to alert emission —
        the latency the benchmark reports p50/p99 over."""
        return self.fired_at_watermark - self.window_end


class AlertSink:
    """Fired-alert log: a bounded in-memory list (``fired`` keeps the
    newest ``keep_last``), complete per-rule totals (``by_rule``,
    ``total``), a push ``hub`` that hands every alert to its subscribers,
    and an optional ``hook`` called with every alert.  Rules call
    ``emit(alert)``."""

    def __init__(self, hook: Optional[Callable[[Alert], None]] = None,
                 keep_last: int = 10_000):
        self.hook = hook
        self.keep_last = keep_last
        self.fired: List[Alert] = []
        self.by_rule: Dict[str, int] = {}
        self.total = 0
        self.hub = SubscriptionHub(name="alert-hub")
        self._lock = threading.Lock()

    def emit(self, alert: Alert) -> None:
        with self._lock:
            self.total += 1
            self.by_rule[alert.rule] = self.by_rule.get(alert.rule, 0) + 1
            self.fired.append(alert)
            if len(self.fired) > self.keep_last:
                del self.fired[: len(self.fired) - self.keep_last]
        self.hub.emit([alert])
        if self.hook is not None:
            self.hook(alert)

    def subscribe(self, callback: Optional[Callable[[Alert], None]] = None,
                  *, capacity: int = 256, key_fn=None) -> Subscription:
        """Push surface: callback fires at emit time, or iterate the
        returned Subscription (bounded per-rule buffers)."""
        return self.hub.subscribe(callback, capacity=capacity, key_fn=key_fn)

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self.total, "by_rule": dict(self.by_rule),
                    "subscribers": self.hub.subscriber_count}


class AlertRule:
    """Base: subclasses implement ``evaluate(agg) -> Optional[Alert]``.

    ``key_prefix`` scopes a rule to the window keys it should see (the
    engine skips non-matching aggregates before ``evaluate``): platform
    health rules set ``key_prefix="__health__."`` so they never fire on
    product channels, and vice versa a product rule can exclude the
    health stream by keying on its channel prefix."""

    name: str = "rule"
    key_prefix: Optional[str] = None

    def applies_to(self, key: str) -> bool:
        return self.key_prefix is None or key.startswith(self.key_prefix)

    def evaluate(self, agg: WindowAggregate) -> Optional[Alert]:
        raise NotImplementedError

    def _fire(self, agg: WindowAggregate, metric: str, value: float,
              message: str, severity: str = "warning") -> Alert:
        return Alert(rule=self.name, key=agg.key,
                     window_start=agg.window_start,
                     window_end=agg.window_end, metric=metric, value=value,
                     message=message, severity=severity,
                     fired_at_watermark=agg.closed_at_watermark)


class ThresholdRule(AlertRule):
    def __init__(self, name: str, metric: str = "count", op: str = ">=",
                 threshold: float = 0.0, severity: str = "warning",
                 key_prefix: Optional[str] = None):
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}")
        self.name, self.metric, self.op = name, metric, op
        self.threshold, self.severity = threshold, severity
        self.key_prefix = key_prefix

    def evaluate(self, agg: WindowAggregate) -> Optional[Alert]:
        v = _metric(agg, self.metric)
        if _OPS[self.op](v, self.threshold):
            return self._fire(
                agg, self.metric, v, severity=self.severity,
                message=(f"{agg.key}: {self.metric}={v:.3g} "
                         f"{self.op} {self.threshold:.3g}"))
        return None


class RateOfChangeRule(AlertRule):
    """Fires when metric grows by >= ``factor`` x vs the previous closed
    window for the same key (both windows must clear ``min_value`` to
    suppress 0 -> 1 noise).

    Order guard: "previous window" is only meaningful for windows
    arriving in time order.  The live operator guarantees that; batch
    REPLAY of an old backlog (repro.store) does not — an out-of-order
    window (end <= the key's newest seen end) is ignored rather than
    allowed to clobber ``_prev`` and corrupt the next live comparison.
    """

    def __init__(self, name: str, metric: str = "count", factor: float = 2.0,
                 min_value: float = 1.0, severity: str = "warning",
                 key_prefix: Optional[str] = None):
        self.name, self.metric = name, metric
        self.factor, self.min_value, self.severity = factor, min_value, severity
        self.key_prefix = key_prefix
        self._prev: Dict[str, float] = {}
        self._last_end: Dict[str, float] = {}

    def evaluate(self, agg: WindowAggregate) -> Optional[Alert]:
        if agg.window_end > agg.closed_at_watermark:
            # force-closed AHEAD of the watermark (a replayed backlog
            # stamped past live time): not part of the key's live
            # timeline — letting it ratchet _last_end forward would
            # silence the rule for every later live window
            return None
        last_end = self._last_end.get(agg.key)
        if last_end is not None and agg.window_end <= last_end:
            return None                  # replayed backfill: no state touch
        self._last_end[agg.key] = agg.window_end
        v = _metric(agg, self.metric)
        prev = self._prev.get(agg.key)
        self._prev[agg.key] = v
        if prev is None or prev < self.min_value or v < self.min_value:
            return None
        if v >= prev * self.factor:
            return self._fire(
                agg, self.metric, v, severity=self.severity,
                message=(f"{agg.key}: {self.metric} jumped {prev:.3g} -> "
                         f"{v:.3g} (x{v / prev:.2f} >= x{self.factor})"))
        return None


class ZScoreRule(AlertRule):
    """Per-key anomaly detection: Welford running mean/variance of the
    metric over past windows; fires when |z| >= ``z``.  The current window
    is folded into history *after* scoring so a spike can't mask itself.
    (Welford folding is order-insensitive, so batch-replayed backfill
    windows join history safely; each window is scored against whatever
    history exists when it arrives.)"""

    def __init__(self, name: str, metric: str = "count", z: float = 3.0,
                 min_history: int = 5, severity: str = "critical",
                 key_prefix: Optional[str] = None):
        self.name, self.metric, self.z = name, metric, z
        self.min_history, self.severity = min_history, severity
        self.key_prefix = key_prefix
        self._hist: Dict[str, Tuple[int, float, float]] = {}  # n, mean, M2

    def evaluate(self, agg: WindowAggregate) -> Optional[Alert]:
        v = _metric(agg, self.metric)
        n, mean, m2 = self._hist.get(agg.key, (0, 0.0, 0.0))
        fired = None
        if n >= self.min_history:
            var = m2 / (n - 1) if n > 1 else 0.0
            std = var ** 0.5
            if std > 1e-12:
                zv = (v - mean) / std
                if abs(zv) >= self.z:
                    fired = self._fire(
                        agg, self.metric, v, severity=self.severity,
                        message=(f"{agg.key}: {self.metric}={v:.3g} is "
                                 f"z={zv:+.2f} vs history "
                                 f"(mean={mean:.3g}, std={std:.3g}, n={n})"))
        n += 1
        delta = v - mean
        mean += delta / n
        m2 += delta * (v - mean)
        self._hist[agg.key] = (n, mean, m2)
        return fired


class RuleEngine:
    """Evaluates every rule against every closed window aggregate."""

    def __init__(self, rules: List[AlertRule], sink: Optional[AlertSink] = None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.rules = list(rules)
        self.sink = sink if sink is not None else AlertSink()
        self.evaluated = 0

    def add_rule(self, rule: AlertRule) -> None:
        """Mount a rule at runtime (names stay unique)."""
        if any(r.name == rule.name for r in self.rules):
            raise ValueError(f"duplicate rule name: {rule.name!r}")
        self.rules.append(rule)

    def process(self, aggregates: List[WindowAggregate]) -> List[Alert]:
        fired: List[Alert] = []
        for agg in aggregates:
            for rule in self.rules:
                if not rule.applies_to(agg.key):
                    continue        # scoped out; no state touch either
                self.evaluated += 1
                alert = rule.evaluate(agg)
                if alert is not None:
                    fired.append(alert)
                    self.sink.emit(alert)
        return fired
