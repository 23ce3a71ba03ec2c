"""repro_torch.core — the parts of the core plane the port's slice needs:
the content-hash dedup window the replay engine keeps (dedup.py)."""
from __future__ import annotations

from repro_torch.core.dedup import DedupWindow, content_hash

__all__ = ["DedupWindow", "content_hash"]
