"""repro_torch.delivery — the parts of the delivery layer the serving
slice needs: the ``Sink`` contract with its counters and health
(base.py) and the push surface ``SubscriptionHub`` (hub.py), through
which ``AlertSink`` and ``ServeEngine`` stream alerts to subscribers.
Batching, retry, fan-out and dispatcher wrappers arrive with the
pipeline slice."""
from repro_torch.delivery.base import (
    CollectingSink,
    LegacySinkAdapter,
    Sink,
    SinkClosedError,
    SinkCounters,
    as_sink,
)
from repro_torch.delivery.hub import Subscription, SubscriptionHub

__all__ = [
    "CollectingSink", "LegacySinkAdapter", "Sink", "SinkClosedError",
    "SinkCounters", "Subscription", "SubscriptionHub", "as_sink",
]
