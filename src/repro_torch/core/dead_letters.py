"""DeadLettersListener (paper): subscribes to overflow from the bounded
mailboxes, keeps monitoring stats (the paper's ELK stack), and fires an
alert hook when the drop rate is unexpected.

Reason taxonomy (the ``reason`` grammar — tests assert published reasons
stay inside it):

  mailbox_overflow              bounded queue/mailbox rejected a message
  malformed_item                worker could not parse a fetched item
  late_event                    event-time older than watermark-lateness
  delivery_failed:<backend>     a delivery backend gave up after retries
                                (<backend> is the terminal sink's name)
  dispatch_overflow:<backend>   a backend's bounded hand-off queue was
                                full (stalled backend, producer faster
                                than dispatch) or still held records
                                when close() abandoned a stuck backend
  unknown                       publisher supplied no reason

Durability: the listener itself only counts (``by_reason`` totals + a
bounded ``recent`` deque).  Pass ``journal=`` (a
``repro_torch.store.DeadLetterJournal``) to persist every published record to
the durable dead-letter log so the ReplayEngine can drain it later; the
journal write happens outside the stats lock and a journal failure never
breaks accounting.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Deque, Dict, List, Optional, Tuple

#: static reasons + prefixes of parameterized families, in one place so
#: tests and docs can't drift from the code
REASON_FAMILIES = ("mailbox_overflow", "malformed_item", "late_event",
                   "delivery_failed:", "dispatch_overflow:", "unknown",
                   # ingestion plane (repro.ingest)
                   "connector_error",       # Connector.fetch raised
                   "unknown_connector",     # source names no registered one
                   "unknown_channel",       # picked for an unopened channel
                   "push_overflow",         # PushConnector buffer bound hit
                   "push_source_removed",   # buffered docs of a removed source
                   # query/serving plane (repro_torch.query)
                   "query_stale",           # watermark lagged past the bound
                   # columnar store plane (repro_torch.store.columnar)
                   "store_cold_unavailable",  # offloaded segment fetch failed
                   "compaction_conflict")   # compaction lost its commit race


def reason_in_taxonomy(reason: str) -> bool:
    """True when ``reason`` matches the documented grammar.  For
    parameterized families (``delivery_failed:<backend>``) the bare
    prefix is NOT a valid reason — the parameter is required."""
    for fam in REASON_FAMILIES:
        if fam.endswith(":"):
            if reason.startswith(fam) and len(reason) > len(fam):
                return True
        elif reason == fam:
            return True
    return False


class DeadLettersListener:
    def __init__(self, alert_threshold: int = 100,
                 alert_hook: Optional[Callable[[str, int], None]] = None,
                 keep_last: int = 1000, journal=None):
        self.alert_threshold = alert_threshold
        self.alert_hook = alert_hook
        self.journal = journal
        self._lock = threading.Lock()
        self.by_reason: Dict[str, int] = collections.defaultdict(int)
        self.total = 0
        self.recent: Deque[Tuple[str, object]] = collections.deque(maxlen=keep_last)
        self.alerts: List[str] = []
        self._subscribers: List[Callable[[str, object], None]] = []

    def subscribe(self, fn: Callable[[str, object], None]) -> None:
        """Register ``fn(reason, msg)`` to observe every publish, in
        publish order, outside the stats lock.  Unlike scanning the
        journal afterwards (whose content is truncated as replay
        cursors advance), a subscriber sees the complete dead-letter
        stream — the chaos harness's accounting ledger hangs off this.
        Subscribers must not raise; a raising subscriber is dropped from
        the accounting path the same way a failing journal write is."""
        self._subscribers.append(fn)

    def publish(self, msg, reason: str = "unknown") -> None:
        fire = False
        with self._lock:
            self.total += 1
            self.by_reason[reason] += 1
            self.recent.append((reason, msg))
            if self.by_reason[reason] == self.alert_threshold:
                alert = (f"dead-letter threshold reached: {reason} x "
                         f"{self.alert_threshold}")
                self.alerts.append(alert)
                fire = True
        if self.journal is not None:
            try:
                self.journal.record(reason, msg)
            except Exception:
                pass        # durability is best-effort; counting is not
        for fn in self._subscribers:
            try:
                fn(reason, msg)
            except Exception:
                pass        # observers are best-effort; counting is not
        if fire and self.alert_hook is not None:
            self.alert_hook(reason, self.alert_threshold)

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self.total, "by_reason": dict(self.by_reason),
                    "alerts": list(self.alerts)}
