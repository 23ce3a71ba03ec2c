"""repro_torch.core — the parts of the core plane the port's slices need:
the content-hash dedup window the replay engine keeps (dedup.py), and the
bounded priority mailboxes (queues.py) and dead-letter listener
(dead_letters.py) behind the serve engine's request admission."""
from __future__ import annotations

from repro_torch.core.dead_letters import DeadLettersListener
from repro_torch.core.dedup import DedupWindow, content_hash
from repro_torch.core.queues import BoundedPriorityQueue, Message

__all__ = ["BoundedPriorityQueue", "DeadLettersListener", "DedupWindow",
           "Message", "content_hash"]
