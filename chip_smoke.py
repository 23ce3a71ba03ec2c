#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each:

  device   torch / CUDA versions and the card's name and power limit
  build    nvcc of every kernel source in src/repro_torch/kernels/csrc
  kernel   window_reduce's contract cases, then the kernel against its
           plain PyTorch version on the card at the main path's shapes
  replay   one virtual day of the paper's deployment (200k sources at
           the simulator's 2 items/source/hour with its diurnal curve,
           the 4 default channels, a numeric value field) appended to a
           ColumnarEventLog, sealed, and replayed through
           StorePlane(device="cuda") into 300 s windows and alert rules;
           held against a pure-numpy count and against device="cpu"
  query    cold and mixed ranges through QueryPlane(device="cuda"),
           held against device="cpu"
  timing   CUDA-event times of the kernel, its plain version and the
           two-call PyTorch yardstick, beside the memory-bound floor
  kernels  one summary line per kernel

then the ``nvidia-smi`` name/power-limit line and, last, the ``ok`` line.
It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository; any failed check ends the run.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"                  # the main path's device (baseline: "cpu")

DAY_S = 86_400.0
WINDOW_S = 300.0                 # pipeline default: 5-minute tumbling windows
CHANNELS = ("news", "custom_rss", "facebook", "twitter")
CHANNEL_MIX = (0.70, 0.15, 0.08, 0.07)   # PipelineConfig.channel_mix
BASE_RATE_PER_HOUR = 2.0         # SourceSimulator's base_rate_per_hour
SEGMENT_BYTES = 1 << 20          # PipelineConfig.segment_bytes
BLOCK_ROWS = 2048                # PipelineConfig.columnar_block_rows
APPEND_BATCH = 512               # documents per log append
TEXT_POOL = 4096                 # distinct (title, body) texts drawn from
SOURCES = 200_000                # the paper's fleet (bench_alertmix.py)
SOURCE_DAY_SEGMENTS = 1_000_000
MIN_EVENTS = 2_332_800           # never replay a smaller day than this
HOT_WINDOWS = 144                # query retention: the newest 12 h per key

# H100 SXM (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# kernel vs plain version: sums are taken in other orders (the plain
# version's CUDA index_add_ uses atomics), so each segment's sum may
# differ by this fraction of its absolute sum, sumsq of its own value
RTOL = 1e-4
ATOL = 1e-6

_WORDS = (
    "market news alert update report breaking global local tech sports "
    "science health economy election storm earnings launch study race "
    "deal vote court data strike rally quake fire flood win loss open"
).split()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


# ---- data ----------------------------------------------------------------

def generate_day(seed: int, sources: int):
    """One virtual day of documents as columns, in publish-time order:
    per source and hour a Poisson count at the simulator's diurnal rate
    (``SourceSimulator._rate``), uniform times within the hour."""
    rng = np.random.default_rng(seed)
    sid = np.arange(sources)
    src_channel = rng.choice(len(CHANNELS), size=sources, p=CHANNEL_MIX)
    ts_parts, src_parts = [], []
    for hour in range(24):
        diurnal = 0.35 + 0.65 * max(
            0.0, math.sin((hour - 5.0) / 24.0 * 2 * math.pi))
        burst = np.maximum(0.1, 1.0 + 0.3 * np.sin(sid % 97 + hour))
        counts = rng.poisson(BASE_RATE_PER_HOUR * diurnal * burst)
        owners = np.repeat(sid, counts)
        ts_parts.append(hour * 3600.0 + rng.random(owners.size) * 3600.0)
        src_parts.append(owners)
    ts = np.concatenate(ts_parts)
    src = np.concatenate(src_parts)
    order = np.argsort(ts, kind="stable")
    ts, src = ts[order], src[order]
    words = rng.integers(0, len(_WORDS), size=(TEXT_POOL, 66))
    texts = [(" ".join(_WORDS[j] for j in row[:6]),
              " ".join(_WORDS[j] for j in row[6:])) for row in words]
    return {"ts": ts, "src": src, "channel": src_channel[src],
            "value": np.round(rng.lognormal(0.0, 1.0, size=ts.size), 4),
            "text": rng.integers(0, TEXT_POOL, size=ts.size),
            "texts": texts}


def append_day(store, day) -> None:
    """Append the day's documents in batches, as a pipeline tees them."""
    ts, src, ch = day["ts"].tolist(), day["src"].tolist(), \
        day["channel"].tolist()
    val, txt, texts = day["value"].tolist(), day["text"].tolist(), \
        day["texts"]
    for lo in range(0, len(ts), APPEND_BATCH):
        batch = []
        for i in range(lo, min(len(ts), lo + APPEND_BATCH)):
            title, body = texts[txt[i]]
            batch.append((f"d{i}", {
                "title": title, "body": body, "published_at": ts[i],
                "sid": f"src-{src[i]:06d}", "channel": CHANNELS[ch[i]],
                "value": val[i]}))
        store.append_documents(batch)
    store.log.roll()


# ---- kernel checks -------------------------------------------------------

def compare(wr, plain, values, seg_ids, num_segments, dev):
    """Kernel vs plain version on the card; -> stats, raises on mismatch."""
    v = torch.as_tensor(values, device=dev)
    g = torch.as_tensor(seg_ids, device=dev)
    a = wr(v, g, num_segments)
    b = wr(v, g, num_segments)
    p = plain(v, g, num_segments)
    absum = plain(v.abs(), g, num_segments)[:, 1]
    torch.cuda.synchronize()
    check(a.shape == (num_segments, 4), "kernel output shape")
    count_eq = torch.equal(a[:, 0], p[:, 0])
    max_eq = torch.equal(a[:, 3], p[:, 3])
    d_sum = (a[:, 1] - p[:, 1]).abs()
    d_sq = (a[:, 2] - p[:, 2]).abs()
    sums_ok = bool(((d_sum <= RTOL * absum + ATOL).all()
                    & (d_sq <= RTOL * p[:, 2] + ATOL).all()).item())
    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    stats = {"n": int(v.shape[0]), "s": num_segments, "count_eq": count_eq,
             "max_eq": max_eq, "sums_within_rtol": sums_ok,
             "max_abs_err": max(float(d_sum.max()), float(d_sq.max())),
             "max_rel_err_sum": float((d_sum / (absum + ATOL)).max()),
             "identical_relaunch": same}
    check(count_eq and max_eq and sums_ok and same,
          f"kernel vs plain version: {stats}")
    return stats


def contract_cases(wr, dev) -> list:
    """window_reduce's contract, each case checked on the card."""
    def run(vals, segs, s):
        out = wr(torch.tensor(vals, dtype=torch.float32, device=dev),
                 torch.tensor(segs, dtype=torch.int32, device=dev), s)
        return out.cpu().numpy()

    inf = float("inf")
    out = run([2.0, 3.0, -1.0], [0, 0, 2], 4)
    check(np.array_equal(out, [[2, 5, 13, 3], [0, 0, 0, -inf],
                               [1, -1, 1, -1], [0, 0, 0, -inf]]),
          f"three-event case: {out.tolist()}")
    out = run([1.0, 2.0, 4.0, 8.0], [-1, 1, -1, 1], 2)
    check(np.array_equal(out, [[0, 0, 0, -inf], [2, 10, 68, 8]]),
          f"-1 padding: {out.tolist()}")
    out = run([1.0, 2.0, 4.0], [5, -7, 0], 2)
    check(np.array_equal(out, [[1, 4, 16, 4], [0, 0, 0, -inf]]),
          f"out-of-range ids ignored: {out.tolist()}")
    out = run([-2.5], [0], 1)
    check(np.array_equal(out, [[1, -2.5, 6.25, -2.5]]), "N=1, S=1")
    # a NaN on lane 1 of the second round: the fold and the tree keep it
    vals = [1.0] * 40
    vals[33] = float("nan")
    out = run(vals + [7.0], [0] * 40 + [1], 2)
    nan = float("nan")
    check(np.array_equal(out, [[40, nan, nan, nan], [1, 7, 49, 7]],
                         equal_nan=True), f"NaN propagates: {out.tolist()}")
    before = wr.launches
    out = wr(torch.empty(0, device=dev),
             torch.empty(0, dtype=torch.int32, device=dev), 3).cpu().numpy()
    check(wr.launches == before and np.array_equal(
        out, [[0, 0, 0, -inf]] * 3), "N=0: empty lanes, no launch")
    return ["three_event", "padding", "out_of_range", "n1_s1", "nan",
            "n0_no_launch"]


# ---- timing --------------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(wr, plain, values, seg_ids, num_segments, dev) -> dict:
    """Kernel, plain version and yardstick in turns (plain, kernel,
    kernel, plain) on one card; bound = the larger of bytes and flops
    over the card's peak rates."""
    v = torch.as_tensor(values, device=dev)
    g = torch.as_tensor(seg_ids, device=dev)
    valid = (g >= 0) & (g < num_segments)
    sid, vv = g[valid].long(), v[valid]
    lanes = torch.stack([torch.ones_like(vv), vv, vv * vv], 1)
    sums = torch.zeros((num_segments, 3), device=dev)
    mx = torch.full((num_segments,), float("-inf"), device=dev)

    def library():               # two PyTorch calls: index_add_ + amax
        sums.index_add_(0, sid, lanes)
        mx.scatter_reduce_(0, sid, vv, reduce="amax", include_self=True)

    p1 = cuda_ms(lambda: plain(v, g, num_segments))
    k1 = cuda_ms(lambda: wr(v, g, num_segments))
    k2 = cuda_ms(lambda: wr(v, g, num_segments))
    p2 = cuda_ms(lambda: plain(v, g, num_segments))
    lib = cuda_ms(library)
    n = int(v.shape[0])
    nbytes = 8 * n + 16 * num_segments
    flops = 4 * n
    bound_s = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
    return {"n": n, "s": num_segments, "ms": (k1 + k2) / 2,
            "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
            "plain_ms_runs": [p1, p2], "library_ms": lib,
            "library_calls": 2, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= flops / PEAK_F32_FLOP_PER_S else "operations")}


# ---- main path -----------------------------------------------------------

def make_stage(alerts_mod):
    """The pipeline's analytics stage with bench_alerts' three rules."""
    return alerts_mod.AnalyticsStage(
        alerts_mod.WindowSpec(kind="tumbling", size_s=WINDOW_S,
                              allowed_lateness_s=300.0),
        [alerts_mod.ThresholdRule("volume", metric="count", op=">=",
                                  threshold=1.0),
         alerts_mod.RateOfChangeRule("surge", metric="count", factor=1.5,
                                     min_value=2.0),
         alerts_mod.ZScoreRule("anomaly", metric="count", z=2.5,
                               min_history=5)],
        watermark_lag_s=60.0,
        key_fn=lambda doc: str(doc.get("key", doc.get("channel", "all"))),
        value_fn=lambda doc: float(doc.get("value", 1.0)))


def agg_rows(aggs):
    return [(a.key, a.window_start, a.window_end, a.count, a.sum, a.sumsq,
             a.max) for a in aggs]


def alert_keys(alerts):
    return [(a.rule, a.key, a.window_start, a.window_end, a.metric, a.value,
             a.severity, a.fired_at_watermark) for a in alerts]


def same_aggregates(got, exp) -> bool:
    """Keys, windows, counts and max exact; sums within RTOL (the values
    are positive, so a sum's own size bounds its rounding)."""
    if [r[:4] + r[6:] for r in got] != [r[:4] + r[6:] for r in exp]:
        return False
    return all(abs(g[i] - e[i]) <= RTOL * abs(e[i]) + ATOL
               for g, e in zip(got, exp) for i in (4, 5))


def numpy_counts(day, spec_size: float) -> dict:
    """Independent reference: documents per (channel, window)."""
    win = np.floor(day["ts"] / spec_size).astype(np.int64)
    key = win * len(CHANNELS) + day["channel"]
    uniq, cnt = np.unique(key, return_counts=True)
    return {(CHANNELS[int(k % len(CHANNELS))],
             float((k // len(CHANNELS)) * spec_size)): int(c)
            for k, c in zip(uniq.tolist(), cnt.tolist())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch.alerts as alerts_mod
    from repro_torch.alerts.batch import pack_columns
    from repro_torch.kernels import build
    from repro_torch.kernels.window_reduce import (window_reduce,
                                                   window_reduce_plain)
    from repro_torch.query import AggQuery, QueryPlane
    from repro_torch.store import ReplayEngine, StorePlane

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build
    t0 = time.perf_counter()
    lines = build.build("window_reduce")
    emit("build", seconds=time.perf_counter() - t0, sources=["window_reduce"],
         ptxas=[ln.strip() for ln in lines
                if "Used" in ln or "entry function" in ln])

    # data for the day (set-up, made in bulk from --seed)
    t0 = time.perf_counter()
    day = generate_day(args.seed, SOURCES)
    generate_s = time.perf_counter() - t0
    n_events = int(day["ts"].size)
    check(n_events >= MIN_EVENTS,
          f"{n_events} events: below the {MIN_EVENTS} floor")
    spec = alerts_mod.WindowSpec(kind="tumbling", size_s=WINDOW_S)
    day_vals, day_segs, day_slots = pack_columns(
        day["ts"], day["channel"], day["value"], spec)
    rng = np.random.default_rng(args.seed + 1)
    shapes = {
        "uniform_200k_x_4096": (
            rng.normal(size=200_000).astype(np.float32),
            rng.integers(0, 4096, size=200_000).astype(np.int32), 4096),
        "channel_day": (day_vals, day_segs, len(day_slots)),
        "source_day": (
            day["value"].astype(np.float32),
            rng.integers(0, SOURCE_DAY_SEGMENTS,
                         size=n_events).astype(np.int32),
            SOURCE_DAY_SEGMENTS),
    }

    # 3. kernel
    cases = contract_cases(window_reduce, dev)
    parity = {name: compare(window_reduce, window_reduce_plain, v, g, s, dev)
              for name, (v, g, s) in shapes.items()}
    emit("kernel", contract_cases=cases, rtol=RTOL, shapes=parity)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 4. replay: the durable read path, end to end
        stage = make_stage(alerts_mod)
        got_aggs = []
        stage.add_export(lambda closed, wm: got_aggs.extend(closed))
        store = StorePlane(tmp, columnar=True, segment_bytes=SEGMENT_BYTES,
                           block_rows=BLOCK_ROWS, analytics=stage,
                           device=DEVICE)
        plane = QueryPlane(stage, log=store.log, staleness_s=None,
                           max_windows_per_key=HOT_WINDOWS,
                           columnar_lanes=True, device=DEVICE)
        t0 = time.perf_counter()
        append_day(store, day)
        append_s = time.perf_counter() - t0

        window_reduce.launches = 0
        t0 = time.perf_counter()
        res = store.replay.replay_log(0, watermark=DAY_S)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = window_reduce.launches
        check(replay_launches > 0, "replay launched no kernel")
        check(res["columnar"] and res["events"] == n_events,
              f"replay result {res}")
        profile = store.replay.status()["profile"]

        cpu_stage = make_stage(alerts_mod)
        cpu_aggs = []
        cpu_stage.add_export(lambda closed, wm: cpu_aggs.extend(closed))
        cpu_plane = QueryPlane(cpu_stage, log=store.log, staleness_s=None,
                               max_windows_per_key=HOT_WINDOWS,
                               columnar_lanes=True, device="cpu")
        cpu_replay = ReplayEngine(log=store.log, analytics=cpu_stage,
                                  device="cpu")
        cpu_replay.replay_log(0, watermark=DAY_S)

        counts = {(a.key, a.window_start): a.count for a in got_aggs}
        numpy_ok = counts == numpy_counts(day, WINDOW_S)
        cpu_ok = same_aggregates(agg_rows(got_aggs), agg_rows(cpu_aggs))
        alerts_ok = alert_keys(stage.alerts) == alert_keys(cpu_stage.alerts)
        finite = all(math.isfinite(x) for r in agg_rows(got_aggs)
                     for x in r[3:])
        emit("replay", sources=SOURCES, cut=None, events=n_events,
             documents=n_events, aggregates=len(got_aggs),
             alerts=len(stage.alerts), by_rule=stage.sink.by_rule,
             launches=replay_launches, generate_s=generate_s,
             append_and_seal_s=append_s, replay_wall_s=replay_s,
             segments=store.log.status()["segments"],
             log_bytes=store.log.status()["appended_bytes"],
             profile={k: {"calls": v["calls"], "total_ms": v["total_ms"],
                          "share": v["share"]}
                      for k, v in profile.items()},
             counts_match_numpy=numpy_ok, parity_with_cpu=cpu_ok,
             alerts_match_cpu=alerts_ok, finite=finite)
        check(len(got_aggs) == len(day_slots), "one aggregate per slot")
        check(numpy_ok, "replay counts vs numpy reference")
        check(cpu_ok and alerts_ok, "replay vs device='cpu'")
        check(finite, "replay aggregates are finite")

        # 5. query: mixed and cold ranges over the news channel
        floor = plane.store.floor
        check(0.0 < floor < DAY_S, f"retention floor {floor}")
        queries = {}
        query_launches = 0
        cold_input = None
        for name, start, end, agg in (
                ("count", 0.0, DAY_S, "count"),
                ("min", 0.0, DAY_S, "min"),
                ("max", 0.0, DAY_S, "max"),
                ("cold_count", 0.0, min(floor, 6 * 3600.0), "count")):
            q = AggQuery(channel="news", start=start, end=end, agg=agg)
            window_reduce.launches = 0
            t0 = time.perf_counter()
            got = plane.query(q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = window_reduce.launches
            query_launches += launches
            exp = cpu_plane.query(q)
            same = [(p["start"], p["end"], p["count"], p["value"])
                    for p in got.points] == \
                [(p["start"], p["end"], p["count"], p["value"])
                 for p in exp.points]
            queries[name] = {"source": got.source, "points": len(got.points),
                             "wall_s": wall, "launches": launches,
                             "parity_with_cpu": same}
            check(launches == 2, f"query {name}: {launches} launches")
            check(same, f"query {name} vs device='cpu'")
            check(got.source == ("cold" if name == "cold_count"
                                 else "mixed"), f"query {name} source")
        lanes = store.log.scan_lanes(ts_min=-WINDOW_S,
                                     ts_max=floor + WINDOW_S,
                                     keys=["news"])
        cold_vals, cold_segs, cold_slots = pack_columns(
            lanes.ts, lanes.key_codes, lanes.values, spec)
        cold_input = (cold_vals, cold_segs, len(cold_slots))
        emit("query", floor=floor, hot_windows_per_key=HOT_WINDOWS,
             queries=queries, launches=query_launches,
             cold_scan_events=lanes.count)
        store.close()

    # 6. timing at the main path's shapes
    shapes["cold_query"] = cold_input
    parity["cold_query"] = compare(window_reduce, window_reduce_plain,
                                   *cold_input, dev)
    timing = {name: time_shape(window_reduce, window_reduce_plain, v, g, s,
                               dev)
              for name, (v, g, s) in shapes.items()}
    emit("timing", card=smi, l2="warm: inputs fresh from the host, as on "
         "the main path", shapes=timing)

    # 7. kernels
    main_shape = timing["channel_day"]
    print(json.dumps({"kernels": [{
        "name": "window_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_reduce.cu",
        "replaces": "src/repro/kernels/window_reduce.py:61",
        "launches": replay_launches + query_launches,
        "max_abs_err": max(p["max_abs_err"] for p in parity.values()),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]}), flush=True)
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
