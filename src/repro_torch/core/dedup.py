"""Duplicate detection (paper Worker: "checks for duplicate entries
already in the system") — a bounded-memory recent-content-hash window,
plus helpers for conditional-GET semantics (eTag / lastModified)."""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Deque, Set


def content_hash(payload: bytes | str) -> str:
    if isinstance(payload, str):
        payload = payload.encode("utf-8", "ignore")
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


class DedupWindow:
    """Sliding window of recently-seen content hashes (FIFO eviction)."""

    def __init__(self, window: int = 1 << 16):
        self._window = window
        self._seen: Set[str] = set()
        self._order: Deque[str] = collections.deque()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def contains(self, h: str) -> bool:
        """Membership peek WITHOUT registering (seen_before registers);
        the replay engine peeks first and registers only once delivery
        is verified."""
        with self._lock:
            return h in self._seen

    def seen_before(self, h: str) -> bool:
        """Returns True if duplicate; registers the hash otherwise."""
        with self._lock:
            if h in self._seen:
                self.hits += 1
                return True
            self.misses += 1
            self._seen.add(h)
            self._order.append(h)
            if len(self._order) > self._window:
                old = self._order.popleft()
                self._seen.discard(old)
            return False

    def __len__(self) -> int:
        return len(self._seen)
