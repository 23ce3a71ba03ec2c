"""Bridge between host-side windowing and the window_reduce segment
reduction.

``pack_events`` flattens (key, event_time, value) triples into the flat
``values`` / ``seg_ids`` tensors ``repro_torch.kernels.window_reduce``
consumes (one segment per distinct (key, window) slot — sliding windows
replicate an event into every covering slot), and ``reduce_events`` turns
the kernel's (S, 4) count/sum/sumsq/max lanes back into
``WindowAggregate`` records.  This is the batch/replay path — reprocessing
a backlog of documents at hardware speed — complementing the incremental
``WindowOperator`` used on the live path; both produce identical
aggregates (tested), so rules don't care which path fed them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.alerts.windows import (SESSION, SLIDING, TUMBLING,
                                        WindowAggregate, WindowSpec)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.window_reduce import window_reduce

Event = Tuple[str, float, float]          # (key, event_time, value)
Slot = Tuple[str, float, float]           # (key, window_start, window_end)


def pack_events(events: Sequence[Event], spec: WindowSpec):
    """-> (values f32 (N,), seg_ids i32 (N,), slots list[Slot]).

    N >= len(events): sliding windows fan each event out to every slot
    covering it.  Session windows are data-driven and stay on the
    incremental operator."""
    if spec.kind == SESSION:
        raise ValueError("session windows have no static slot layout; "
                         "use WindowOperator")
    slot_ids: Dict[Slot, int] = {}
    vals: List[float] = []
    segs: List[int] = []
    for key, t, v in events:
        for start, end in spec.assign(t):
            slot = (key, start, end)
            sid = slot_ids.setdefault(slot, len(slot_ids))
            vals.append(v)
            segs.append(sid)
    slots = [s for s, _ in sorted(slot_ids.items(), key=lambda kv: kv[1])]
    return (np.asarray(vals, np.float32), np.asarray(segs, np.int32), slots)


def pack_columns(ts: np.ndarray, key_codes: np.ndarray,
                 values: np.ndarray, spec: WindowSpec):
    """Vectorized ``pack_events`` over COLUMN arrays (the columnar
    store's ``scan_lanes`` output): no per-event Python at all.

    -> (values f32 (N,), seg_ids i32 (N,), slots list[(key_code,
    start, end)]).  Window starts replicate ``WindowSpec.assign``'s
    exact float arithmetic (tumbling: one floor-multiply; sliding: the
    same repeated subtraction, vectorized per step) so slots from the
    two packers are bit-identical — the hot/cold dedup in the query
    plane depends on it."""
    if spec.kind == SESSION:
        raise ValueError("session windows have no static slot layout; "
                         "use WindowOperator")
    ts = np.asarray(ts, np.float64)
    codes = np.asarray(key_codes, np.int64)
    vals = np.asarray(values, np.float64)
    if ts.size == 0:
        return (np.empty(0, np.float32), np.empty(0, np.int32), [])
    if spec.kind == TUMBLING:
        estarts = np.floor(ts / spec.size_s) * spec.size_s
        ecodes, evals = codes, vals
    else:                                 # SLIDING
        slide = float(spec.slide_s)
        cur = np.floor(ts / slide) * slide
        lower = ts - spec.size_s
        parts_s: List[np.ndarray] = []
        parts_c: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []
        while True:
            m = cur > lower
            if not m.any():
                break
            parts_s.append(cur[m])
            parts_c.append(codes[m])
            parts_v.append(vals[m])
            cur = cur - slide
        estarts = np.concatenate(parts_s)
        ecodes = np.concatenate(parts_c)
        evals = np.concatenate(parts_v)
    # one (key, start) slot per distinct pair; codes fit float64 exactly
    combo = np.column_stack([estarts, ecodes.astype(np.float64)])
    uniq, inv = np.unique(combo, axis=0, return_inverse=True)
    slots = [(int(c), float(s), float(s) + spec.size_s)
             for s, c in uniq]
    return (evals.astype(np.float32), inv.astype(np.int32).ravel(), slots)


def reduce_columns(ts: np.ndarray, key_codes: np.ndarray,
                   values: np.ndarray, key_vocab: Sequence[str],
                   spec: WindowSpec, *, device="cuda", profiler=None,
                   with_min: bool = False) -> List[WindowAggregate]:
    """``reduce_events`` fed by column arrays: pack_columns ->
    window_reduce -> WindowAggregates, with the same profiler stage
    names so the replay breakdown stays comparable.  Per-record Python
    appears only in the final per-SLOT unpack (S slots, not N events)."""
    stage = profiler.stage if profiler is not None else (
        lambda name: _NULL_STAGE)
    with stage("pack_events"):
        packed_vals, seg_ids, slots = pack_columns(
            ts, key_codes, values, spec)
    if not slots:
        return []
    with stage("kernel"):
        lanes, mins = _lanes(packed_vals, seg_ids, len(slots), device,
                             with_min)
    with stage("unpack"):
        out: List[WindowAggregate] = []
        for sid, (code, start, end) in enumerate(slots):
            cnt, sm, sq, mx = lanes[sid]
            agg = WindowAggregate(
                key=key_vocab[code], window_start=start, window_end=end,
                count=int(round(cnt)), sum=float(sm), sumsq=float(sq),
                max=float(mx))
            if mins is not None:
                agg.min = float(mins[sid])
            out.append(agg)
        out.sort(key=lambda a: (a.window_end, a.key))
    return out


class _NullStage:
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_STAGE = _NullStage()


def _lanes(values: np.ndarray, seg_ids: np.ndarray, num_slots: int,
           device, with_min: bool):
    """-> ((S, 4) count/sum/sumsq/max lanes, per-slot mins or None) as
    numpy, from one upload and one or two kernel launches on ``device``."""
    dev = resolve_device(device)
    vals = torch.from_numpy(values).to(dev)
    segs = torch.from_numpy(seg_ids).to(dev)
    lanes = window_reduce(vals, segs, num_slots).cpu().numpy()
    mins = None
    if with_min:
        neg = window_reduce(-vals, segs, num_slots).cpu().numpy()
        mins = -neg[:, 3]
    return lanes, mins


def reduce_events(events: Sequence[Event], spec: WindowSpec, *,
                  device="cuda", profiler=None,
                  with_min: bool = False) -> List[WindowAggregate]:
    """One kernel launch -> WindowAggregates for every touched slot.

    ``profiler`` (a ``repro_torch.obs.StageProfiler``) itemizes the chain
    into pack_events / kernel / unpack stages (the kernel stage includes
    the upload and the read-back).

    ``with_min=True`` adds a second launch over the negated values —
    ``min(v) = -max(-v)`` — so per-slot minima come out of the same
    4-lane kernel without changing its pinned (S, 4) output shape.  The
    query plane (repro_torch.query) needs min; the rule engine's live
    path already tracks it incrementally."""
    stage = profiler.stage if profiler is not None else (
        lambda name: _NULL_STAGE)
    with stage("pack_events"):
        values, seg_ids, slots = pack_events(events, spec)
    if not slots:
        return []
    with stage("kernel"):
        lanes, mins = _lanes(values, seg_ids, len(slots), device, with_min)
    with stage("unpack"):
        out: List[WindowAggregate] = []
        for sid, (key, start, end) in enumerate(slots):
            cnt, sm, sq, mx = lanes[sid]
            agg = WindowAggregate(
                key=key, window_start=start, window_end=end,
                count=int(round(cnt)), sum=float(sm), sumsq=float(sq),
                max=float(mx))
            if mins is not None:
                agg.min = float(mins[sid])
            out.append(agg)
        out.sort(key=lambda a: (a.window_end, a.key))
    return out
