"""repro_torch.obs — observability for the port's slice: the always-on
per-stage wall-clock profiler the replay engine carries (profiler.py)."""
from __future__ import annotations

from repro_torch.obs.profiler import StageProfiler

__all__ = ["StageProfiler"]
