"""Bounded stable-priority mailboxes (paper: "Bounded mail box is required
to apply back pressure and to avoid long backlog ... Priority mail box is
required to enable on priority message processing").

Overflow is routed to the dead-letters listener instead of raising when a
listener is attached (the paper's DeadLettersListener pattern).
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional


class QueueFullError(Exception):
    pass


@dataclass(order=False)
class Message:
    priority: int                 # 0 = highest
    payload: Any
    sid: int = -1
    channel: str = ""
    enqueued_at: float = 0.0
    seq: int = 0                  # stable FIFO order within a priority


class BoundedPriorityQueue:
    """Stable priority queue with a hard capacity bound."""

    def __init__(self, capacity: int, priorities: int = 3,
                 dead_letters: Optional["DeadLettersLike"] = None):
        self.capacity = capacity
        self._lanes: List[Deque[Message]] = [
            collections.deque() for _ in range(priorities)
        ]
        self._size = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dead_letters = dead_letters
        self.stats = {"offered": 0, "accepted": 0, "dropped": 0, "polled": 0}

    def __len__(self) -> int:
        return self._size

    def offer(self, msg: Message) -> bool:
        """Non-blocking enqueue.

        Stats contract (audited; counts are per offer *attempt*):
          * every call increments ``offered`` exactly once, and then
            exactly one of ``accepted`` / ``dropped`` — so
            ``accepted + dropped == offered`` always holds;
          * on overflow the message is counted ``dropped`` exactly once,
            then either published to the dead-letters listener (returns
            False — the queue has consumed the message) or, with no
            listener attached, ``QueueFullError`` is raised and the
            CALLER still owns the message.  A retry after the exception
            is a new offer attempt and is counted again (per-attempt, not
            per-message).
        """
        with self._lock:
            self.stats["offered"] += 1
            if self._size >= self.capacity:
                self.stats["dropped"] += 1            # exactly once per attempt
                if self.dead_letters is None:
                    raise QueueFullError(f"capacity {self.capacity} exceeded")
                self.dead_letters.publish(msg, reason="mailbox_overflow")
                return False
            msg.seq = self._seq
            self._seq += 1
            lane = min(msg.priority, len(self._lanes) - 1)
            self._lanes[lane].append(msg)
            self._size += 1
            self.stats["accepted"] += 1
            self._not_empty.notify()
            return True

    def poll(self, timeout: Optional[float] = 0.0) -> Optional[Message]:
        """Dequeue highest-priority message; None if empty (after timeout)."""
        with self._not_empty:
            if self._size == 0 and timeout:
                self._not_empty.wait(timeout)
            for lane in self._lanes:
                if lane:
                    self._size -= 1
                    self.stats["polled"] += 1
                    return lane.popleft()
            return None

    def poll_batch(self, max_items: int) -> List[Message]:
        out: List[Message] = []
        with self._lock:
            while len(out) < max_items:
                got = None
                for lane in self._lanes:
                    if lane:
                        got = lane.popleft()
                        break
                if got is None:
                    break
                self._size -= 1
                self.stats["polled"] += 1
                out.append(got)
        return out
