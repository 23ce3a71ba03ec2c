"""DeadLetterJournal — durable companion to ``DeadLettersListener``.

The listener only *counts* (bounded ``recent`` deque): a backend outage
used to mean every ``delivery_failed:<backend>`` record was gone for
good.  The journal hooks ``DeadLettersListener(journal=...)`` and
persists every published record into an ``EventLog`` as

    {"reason": "<taxonomy reason>", "record": <json-safe record>}

so the ReplayEngine can drain it later.  Replay progress is tracked as
one durable cursor PER REASON (``cursor.json``, atomic rewrite): two
backends can fail and recover independently without clobbering each
other's backlog position, and the log is truncated only past the
minimum cursor so no reason's unread records are released early.

Records are made JSON-safe best-effort: ``(doc_id, doc)`` delivery
tuples and dict/list/scalar payloads survive verbatim; anything else is
wrapped as ``{"_repr": repr(obj)}`` (still countable and replayable as
a taxonomy record, just not re-deliverable — e.g. mailbox-overflow
``Message`` objects carry live payload references).
"""
from __future__ import annotations

import bisect
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.store.segment_log import EventLog

CURSORS = "cursors.json"

#: reasons with a replay route pin the truncation floor until their
#: cursor moves; monitoring-only reasons (mailbox_overflow,
#: malformed_item, unknown) are counted + journaled but must not block
#: space reclaim forever — they are retained until replay-driven
#: truncation catches up (or a caller advance()s them explicitly)
_REPLAYABLE = ("late_event",)
_REPLAYABLE_PREFIXES = ("delivery_failed:",)


def replayable(reason: str) -> bool:
    return reason in _REPLAYABLE or any(
        reason.startswith(p) and len(reason) > len(p)
        for p in _REPLAYABLE_PREFIXES)


def json_safe(obj):
    """Best-effort projection of an arbitrary dead-lettered record onto
    JSON: exact for the shapes the platform actually publishes
    ((doc_id, doc) tuples, dicts, scalars), ``{"_repr": ...}`` otherwise."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        pass
    if isinstance(obj, (list, tuple)):
        return [json_safe(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    return {"_repr": repr(obj)}


class DeadLetterJournal:
    """Durable dead-letter store with per-reason replay cursors.

      record(reason, msg)        called by DeadLettersListener.publish
      scan(reason, from_offset)  checksummed read of one reason's records
      cursor(reason)             replay position (0 = never replayed)
      advance(reason, offset)    persist progress; truncates the log past
                                 min(cursors) when every reason moved on
      pending()                  {reason: records not yet replayed}
    """

    def __init__(self, dir_path: str, *, segment_bytes: int = 1 << 20,
                 fsync: bool = False):
        self.dir = dir_path
        self.log = EventLog(dir_path, segment_bytes=segment_bytes,
                            fsync=fsync)
        self._lock = threading.Lock()
        self._cursors: Dict[str, int] = {}
        # per-reason SORTED offset index (offsets are assigned
        # monotonically, so appends keep it sorted): reasons()/pending()
        # are O(1)/O(log n) bisects instead of a full disk rescan per
        # metrics refresh; rebuilt from one scan at open
        self._offsets: Dict[str, List[int]] = {}
        path = os.path.join(self.dir, CURSORS)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                self._cursors = {k: int(v)
                                 for k, v in json.load(fh).items()}
        for off, payload in self.log.scan(self.log.truncated_through):
            r = payload.get("reason", "unknown")
            self._offsets.setdefault(r, []).append(off)

    # ---- write side (DeadLettersListener hook) -----------------------------
    def record(self, reason: str, msg) -> int:
        """Persist one dead-lettered record; returns its log offset."""
        first, _last = self.log.append(
            [{"reason": reason, "record": json_safe(msg)}])
        with self._lock:
            self._offsets.setdefault(reason, []).append(first)
        return first

    def tick(self, now: float) -> None:
        self.log.tick(now)

    # ---- read / replay-progress side ---------------------------------------
    def scan(self, reason: Optional[str] = None,
             from_offset: int = 0) -> Iterator[Tuple[int, object]]:
        """Yield (offset, record) for every journaled record, filtered
        to one ``reason`` when given (prefix ``"x:"`` reasons match
        exactly, not by family)."""
        for off, payload in self.log.scan(from_offset):
            if reason is None or payload.get("reason") == reason:
                yield off, payload["record"]

    def reasons(self) -> Dict[str, int]:
        """Journaled-record counts per reason (records still on disk or
        seen since open; truncated history drops out at the next open)."""
        with self._lock:
            return {r: len(offs) for r, offs in self._offsets.items()}

    def cursor(self, reason: str) -> int:
        with self._lock:
            return self._cursors.get(reason, self.log.truncated_through)

    def first_pending(self, reason: str) -> Optional[int]:
        """Offset of the oldest not-yet-replayed record for ``reason``
        (None when its backlog is empty) — answered from the in-memory
        index so replay passes can skip the disk entirely when there is
        nothing to do."""
        with self._lock:
            offs = self._offsets.get(reason)
            if not offs:
                return None
            i = bisect.bisect_left(offs, self._cursors.get(reason, 0))
            return offs[i] if i < len(offs) else None

    def advance(self, reason: str, offset: int) -> None:
        """Persist that ``reason`` has been replayed through ``offset``
        (exclusive); then release sealed segments every PINNING reason
        is past — replayable reasons without a cursor pin the floor at
        their unread backlog, monitoring-only reasons never pin (see
        ``replayable``)."""
        with self._lock:
            if offset <= self._cursors.get(reason, 0):
                return
            self._cursors[reason] = offset
            tmp = os.path.join(self.dir, CURSORS + ".tmp")
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self._cursors, fh)
            os.replace(tmp, os.path.join(self.dir, CURSORS))
            pins = [self._cursors[r] if r in self._cursors else 0
                    for r in self._offsets
                    if r in self._cursors or replayable(r)]
            floor = min(pins) if pins else 0
        if floor:
            self.log.truncate(floor)
            tt = self.log.truncated_through
            with self._lock:             # drop index entries for records
                for offs in self._offsets.values():   # no longer on disk
                    del offs[:bisect.bisect_left(offs, tt)]

    def pending(self) -> Dict[str, int]:
        """Records not yet replayed, per reason — answered from the
        in-memory offset index (O(log n) per reason), NOT a disk rescan:
        this runs on every Metrics.store refresh."""
        out: Dict[str, int] = {}
        with self._lock:
            for r, offs in self._offsets.items():
                n = len(offs) - bisect.bisect_left(offs, self._cursors.get(r, 0))
                if n:
                    out[r] = n
        return out

    def status(self) -> dict:
        return {"reasons": self.reasons(),
                "cursors": dict(self._cursors),
                "log": self.log.status()}

    def close(self) -> None:
        self.log.close()
