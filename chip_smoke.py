#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each:

  device   torch / CUDA versions and the card's name and power limit
  build    nvcc of every kernel source in src/repro_torch/kernels/csrc,
           all started together
  kernel   window_reduce's contract cases, then the kernel against its
           plain PyTorch version on the card at the main path's shapes
  replay   one virtual day of the paper's deployment, cut to 100k of its
           200k sources (the simulator's 2 items/source/hour with its
           diurnal curve, the 4 default channels, a numeric value field)
           appended to a ColumnarEventLog, sealed, and replayed through
           StorePlane(device="cuda") into 300 s windows and alert rules;
           held against a pure-numpy count and against device="cpu"
  query    cold and mixed ranges through QueryPlane(device="cuda"),
           held against device="cpu"
  timing   CUDA-event times of window_reduce, its plain version and the
           two-call PyTorch yardstick, beside the memory-bound floor
  flash_kernel
           flash_attention's contract cases on the card against its
           plain version (dtype x mask x GQA group x head dim x length)
  flash_timing
           CUDA-event times of flash_attention, its plain version and
           scaled_dot_product_attention at Qwen2.5-3B's prefill shapes,
           beside the bound
  serve    Qwen2.5-3B at full width and depth (random weights from
           --seed) behind ServeEngine(device="cuda"): 16 requests of 7
           to 2,999 prompt tokens, 32 greedy tokens each; the six short
           ones replayed on the same weights through
           ServeEngine(device="cpu") and held token for token
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"                  # the main path's device (baseline: "cpu")
KERNEL_SOURCES = ("window_reduce", "flash_attention")   # csrc/<name>.cu

DAY_S = 86_400.0
WINDOW_S = 300.0                 # pipeline default: 5-minute tumbling windows
CHANNELS = ("news", "custom_rss", "facebook", "twitter")
CHANNEL_MIX = (0.70, 0.15, 0.08, 0.07)   # PipelineConfig.channel_mix
BASE_RATE_PER_HOUR = 2.0         # SourceSimulator's base_rate_per_hour
SEGMENT_BYTES = 1 << 20          # PipelineConfig.segment_bytes
BLOCK_ROWS = 2048                # PipelineConfig.columnar_block_rows
APPEND_BATCH = 512               # documents per log append
TEXT_POOL = 4096                 # distinct (title, body) texts drawn from
FLEET = 200_000                  # the paper's fleet (bench_alertmix.py)
SOURCES = 100_000                # cut to half (see CUT) to fit the run
CUT = {"sources": SOURCES, "of": FLEET,
       "why": "append and seal of the full day took 286-404 s on the host; "
              "half the fleet keeps the script under 600 s with the serve "
              "phase"}
SOURCE_DAY_SEGMENTS = 1_000_000
MIN_EVENTS = 2_332_800           # never replay a smaller day than this
HOT_WINDOWS = 144                # query retention: the newest 12 h per key

# H100 SXM (NVIDIA data sheet, dense rates): HBM3 bytes/s, f32 (non-tensor)
# flop/s and bf16 tensor-core flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# kernel vs plain version: sums are taken in other orders (the plain
# version's CUDA index_add_ uses atomics), so each segment's sum may
# differ by this fraction of its absolute sum, sumsq of its own value
RTOL = 1e-4
ATOL = 1e-6

# flash_attention vs its plain version, per dtype: the tolerances of
# tests/test_kernels.py:29 (the kernel folds its softmax tile by tile, the
# plain version over the whole row, and rounds p to bf16 at other maxima)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_TIMED_S = (128, 512, 2048)           # Qwen2.5-3B prefill lengths

SERVE_ARCH = "qwen2.5-3b"
SHORT_PROMPTS = (7, 19, 45, 64, 100, 128)  # also replayed on the CPU
LONG_PROMPTS = (129, 257, 515, 777, 1024, 1333, 1801, 2048, 2500, 2999)
PRIORITY_REQUESTS = 3                      # 20% of 16, rounded down
MAX_NEW = 32
# Card vs CPU greedy streams: where they part, the CPU's top-2 logit margin
# at that step must be within this share of the step's largest |logit|:
# bf16 keeps 8 significant bits, and the two devices round the bf16
# products of 36 layers at other places, so near-ties may flip.
NEAR_TIE = 2e-2
PROFILED_STEPS = 4               # decode steps under torch.profiler
# f32 card vs CPU logits, as a share of their largest |logit|: the same sums
# in other orders through 36 layers (1.25e-4 measured on an H100)
F32_TOL = 1e-3
# The f32 engine check: requests as (cut of the longest short prompt,
# max_new_tokens).  The first eight fill every slot; the 128 and 100 token
# ones finish after 3 tokens, which admits the last two into their used
# slots while the other six decode on.
F32_REQUESTS = ((7, 6), (19, 6), (45, 6), (64, 6), (100, 3), (128, 3),
                (33, 6), (90, 6), (11, 4), (25, 4))

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


# ---- flash attention -----------------------------------------------------

def flash_contract_cases(fa, plain, dev) -> dict:
    """flash_attention's contract on the card: every dtype x mask x GQA
    group x head dim x length, then every prompt length the serve phase
    prefills at Qwen2.5-3B's shape (B = 1, 16 query and 2 kv heads of 128,
    causal); each launched twice (the bytes must repeat) and held against
    the plain version at FLASH_TOL."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {str(t): 0.0 for t in FLASH_TOL}
    cases = []
    for dtype in FLASH_TOL:
        for causal, window in ((True, 0), (False, 0), (True, 64)):
            for hq, hkv in ((4, 4), (4, 2), (16, 2)):       # groups 1, 2, 8
                for d in (16, 80, 128):
                    for s in (1, 37, 2048):
                        cases.append((dtype, 1 if s > 64 else 2, s, hq, hkv,
                                      d, causal, window))
        for s in SHORT_PROMPTS + LONG_PROMPTS:
            cases.append((dtype, 1, s, 16, 2, 128, True, 0))
    for dtype, b, s, hq, hkv, d, causal, window in cases:
        tol = FLASH_TOL[dtype]
        q, k, v = (torch.randn(b, s, h, d, generator=gen,
                               device=dev).to(dtype) for h in (hq, hkv, hkv))
        o = fa(q, k, v, causal=causal, window=window)
        o2 = fa(q, k, v, causal=causal, window=window)
        p = plain(q, k, v, causal=causal, window=window).float()
        err = (o.float() - p).abs()
        ok = bool((err <= tol + tol * p.abs()).all())
        same = torch.equal(o, o2)
        check(ok and same and o.shape == q.shape,
              f"flash_attention {dtype} b={b} causal={causal} "
              f"window={window} hq={hq} hkv={hkv} d={d} s={s}: max err "
              f"{float(err.max())}, identical relaunch {same}")
        worst[str(dtype)] = max(worst[str(dtype)], float(err.max()))
    return {"cases": len(cases),
            "serve_lengths": list(SHORT_PROMPTS + LONG_PROMPTS),
            "max_abs_err": worst}


def flash_bound(s: int, hq: int, hkv: int, d: int, itemsize: int) -> dict:
    """Least time of one causal pass on the card: flops of the live
    (query, key) pairs over the bf16 tensor-core rate, or q, k, v and o
    moved once over HBM, whichever is larger."""
    flops = 4 * hq * d * s * (s + 1) // 2
    nbytes = itemsize * (2 * s * hq * d + 2 * s * hkv * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def flash_timing(fa, plain, dev) -> dict:
    """Kernel, plain version (plain, kernel, kernel, plain) and, as a
    yardstick only, scaled_dot_product_attention at Qwen2.5-3B's prefill
    shapes: B = 1, 16 query and 2 kv heads of 128, bf16, causal."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for s in FLASH_TIMED_S:
        q = torch.randn(1, s, 16, 128, device=dev, dtype=torch.bfloat16)
        k = torch.randn(1, s, 2, 128, device=dev, dtype=torch.bfloat16)
        v = torch.randn(1, s, 2, 128, device=dev, dtype=torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        p1 = cuda_ms(lambda: plain(q, k, v))
        k1 = cuda_ms(lambda: fa(q, k, v))
        k2 = cuda_ms(lambda: fa(q, k, v))
        p2 = cuda_ms(lambda: plain(q, k, v))
        lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                   enable_gqa=True))
        out[s] = {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2],
                  "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                  "library_ms": lib, **flash_bound(s, 16, 2, 128, 2)}
    return out


# ---- serving -------------------------------------------------------------

class Traced:
    """The model as a ServeEngine sees it, with every prefill and decode
    call timed on the host clock between two synchronisations, and, for
    the requests whose prompts are in ``record`` ({prompt: rid}), each
    greedy step's logits kept (prefill gives a request's first token,
    each decode step one more for every active slot).  With ``follow``
    ({rid: tokens}) the engine is handed, in place of each kept row, a
    one-hot on the followed stream's token at that step, so it decodes
    that stream (teacher forcing); ``cache_dtype`` sets the engine's
    cache type."""

    def __init__(self, model, dev, record, *, follow=None,
                 cache_dtype=None):
        self.model, self.dev, self.record = model, dev, record
        self.recorded = set(record.values())
        self.follow, self.cache_dtype = follow, cache_dtype
        self.engine = None
        self.prefill_s, self.decode_s = [], []
        self.prefilled_at = {}           # prompt -> engine clock, synced
        self.logits = {}                 # rid -> [f32 CPU row per token]
        self.live = []                   # recorded active slots per step

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _keep(self, logits, rows):
        """Keep each (row, rid)'s logits; the engine's argmax then reads
        the followed stream's token where ``follow`` is set."""
        for row, rid in rows:
            self.logits.setdefault(rid, []).append(logits[row].float().cpu())
        if self.follow is None:
            return logits
        forced = torch.zeros_like(logits)
        for row, rid in rows:
            forced[row, self.follow[rid][len(self.logits[rid]) - 1]] = 1.0
        return forced

    def init_cache(self, batch_size, max_seq, *, device="cuda"):
        if self.cache_dtype is None:
            return self.model.init_cache(batch_size, max_seq, device=device)
        from repro_torch.models import transformer as T
        return T.init_cache(self.model.cfg, batch_size, max_seq,
                            dtype=self.cache_dtype, device=device)

    def prefill(self, params, batch, **kw):
        self._sync()
        t0 = time.perf_counter()
        last, cache = self.model.prefill(params, batch, **kw)
        self._sync()
        self.prefill_s.append((batch["tokens"].shape[1],
                               time.perf_counter() - t0))
        prompt = tuple(batch["tokens"][0].tolist())
        self.prefilled_at[prompt] = time.monotonic()
        rid = self.record.get(prompt)
        return self._keep(last, [] if rid is None else [(0, rid)]), cache

    def decode_step(self, params, cache, tokens):
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.model.decode_step(params, cache, tokens)
        self._sync()
        self.decode_s.append(time.perf_counter() - t0)
        eng = self.engine
        rows = [(slot, req.rid) for slot, req in enumerate(eng.slot_req)
                if req is not None and eng.active[slot]
                and req.rid in self.recorded]
        self.live.append(len(rows))
        return self._keep(logits, rows), cache


def make_requests(seed: int, vocab: int):
    """16 requests, prompts from HashTokenizer over random words: six of
    SHORT_PROMPTS tokens and ten of LONG_PROMPTS, in a seeded order, three
    of them priority 0."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.serve.engine import Request
    tok = HashTokenizer(vocab)
    rng = np.random.default_rng(seed + 2)
    lengths = list(SHORT_PROMPTS) + list(LONG_PROMPTS)
    order = rng.permutation(len(lengths))
    prio = set(rng.choice(len(lengths), PRIORITY_REQUESTS,
                          replace=False).tolist())
    reqs = []
    for rid, i in enumerate(order.tolist()):
        n_words = lengths[i] - 1                  # plus the bos token
        words = " ".join(f"{_WORDS[a]}-{b}" for a, b in zip(
            rng.integers(0, len(_WORDS), n_words),
            rng.integers(0, 1000, n_words)))
        ids = tok.encode(words, add_eos=False)
        check(len(ids) == lengths[i], f"prompt of {len(ids)} tokens")
        reqs.append(Request(rid=rid, prompt_tokens=ids,
                            max_new_tokens=MAX_NEW,
                            priority=0 if rid in prio else 1))
    return reqs


def _pair_gap(card: torch.Tensor, cpu: torch.Tensor) -> float:
    """How far the card moves the CPU's top-2 margin at one step."""
    a, b = torch.topk(cpu, 2).indices.tolist()
    return abs(float((card[a] - card[b]) - (cpu[a] - cpu[b])))


def compare_streams(card_reqs, card_logits, cpu_reqs, cpu_logits) -> dict:
    """Per request: the card's and the CPU's greedy tokens; where they
    part, the CPU's top-2 margin at that step against NEAR_TIE of the
    step's largest |logit|; while they agree, the largest gap between the
    two devices' logits and between their top-2 margins."""
    out = {}
    for rid, cpu_req in cpu_reqs.items():
        a, b = card_reqs[rid].output_tokens, cpu_req.output_tokens
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None if len(a) == len(b) else min(len(a), len(b)))
        agree = len(a) if first is None else first
        pairs = list(zip(card_logits[rid][:agree], cpu_logits[rid][:agree]))
        gaps = [float((g - c).abs().max()) for g, c in pairs]
        margin_gaps = [_pair_gap(g, c) for g, c in pairs]
        row = {"prompt": len(cpu_req.prompt_tokens), "tokens": len(b),
               "equal": first is None, "first_diff": first,
               "max_logit_gap_while_equal": max(gaps) if gaps else None,
               "max_margin_gap_while_equal":
                   max(margin_gaps) if margin_gaps else None}
        if first is not None:
            c = cpu_logits[rid][first]
            top2 = torch.topk(c, 2).values
            row["margin"] = float(top2[0] - top2[1])
            row["tolerance"] = NEAR_TIE * float(c.abs().max())
            row["near_tie"] = row["margin"] <= row["tolerance"]
        out[rid] = row
    return out


def serve_phase(seed: int, dev, fa) -> dict:
    """Qwen2.5-3B at full width and depth behind ServeEngine(device=dev),
    then the short requests again through ServeEngine(device="cpu") on
    the same weights."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_arch(SERVE_ARCH).model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(max_batch=8, max_seq_len=4096, replenish_after=2,
                       replenish_timeout_s=0.02)
    reqs = make_requests(seed, cfg.vocab)
    short = {tuple(r.prompt_tokens): r.rid for r in reqs
             if len(r.prompt_tokens) <= SHORT_PROMPTS[-1]}
    longest_short = max(short, key=len)
    traced = Traced(model, dev, short)
    eng = ServeEngine(traced, params, scfg, eos_id=-1, device=dev)
    traced.engine = eng
    torch.cuda.reset_peak_memory_stats(dev)

    fa.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        r.arrived_at = time.monotonic()           # the engine's clock
        check(eng.submit(r), f"request {r.rid} refused")
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches

    vp = params.embed_tokens.shape[0]
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} requests done")
    check(all(len(r.output_tokens) == MAX_NEW and
              all(0 <= t < vp for t in r.output_tokens) for r in done),
          "every request gives MAX_NEW tokens in the vocabulary")
    check(launches == cfg.n_layers * len(reqs),
          f"{launches} flash_attention launches, want "
          f"{cfg.n_layers} x {len(reqs)}")
    # a first token is ready when its request's prefill has synchronised
    ttft = {p: [traced.prefilled_at[tuple(r.prompt_tokens)] - r.arrived_at
                for r in done if r.priority == p] for p in (0, 1)}
    # the kernel's share of prefill: each prompt's length timed alone on
    # the card, once per layer, over the synchronised prefill time
    kernel_ms = 0.0
    for r in reqs:
        s = len(r.prompt_tokens)
        q = torch.randn(1, s, cfg.n_heads, cfg.resolved_head_dim, device=dev,
                        dtype=torch.bfloat16)
        kv = torch.randn(1, s, cfg.n_kv_heads, cfg.resolved_head_dim,
                         device=dev, dtype=torch.bfloat16)
        kernel_ms += cfg.n_layers * cuda_ms(lambda: fa(q, kv, kv), reps=5,
                                            warmup=1)
    prefill_s = sum(t for _, t in traced.prefill_s)
    decode_s = sum(traced.decode_s)
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in params.parameters()),
        "init_s": init_s, "requests": len(reqs), "done": len(done),
        "priority_requests": PRIORITY_REQUESTS,
        "prompt_lengths": [len(r.prompt_tokens) for r in reqs],
        "prefill_tokens": sum(len(r.prompt_tokens) for r in reqs),
        "decode_steps": eng.steps, "tokens_generated": eng.tokens_generated,
        "tokens_per_s": eng.tokens_generated / wall, "wall_s": wall,
        "ttft_s": {("priority" if p == 0 else "normal"): {
            "mean": float(np.mean(v)), "max": float(np.max(v))}
            for p, v in ttft.items()},
        "flash_attention_launches": launches,
        "prefill_calls": len(traced.prefill_s), "prefill_s": prefill_s,
        "prefill_s_by_length": list(traced.prefill_s),
        "decode_calls": len(traced.decode_s), "decode_s": decode_s,
        "other_s": wall - prefill_s - decode_s,
        "decode_ms_per_step": 1e3 * decode_s / max(1, len(traced.decode_s)),
        "kernel_share_of_prefill": kernel_ms / 1e3 / prefill_s,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }

    result["decode_profile"] = profile_decode(
        eng, [Request(rid=1000 + i, prompt_tokens=list(longest_short),
                      max_new_tokens=PROFILED_STEPS + 2)
              for i in range(scfg.max_batch)])

    # the check: the short requests again, on the CPU, same weights
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    tree = params.to_tree()
    tree_cpu = _tree_map(lambda t: t.cpu(), tree)
    cpu_params = model.params_from_tree(tree_cpu)
    traced_cpu = Traced(model, cpu, short)
    eng_cpu = ServeEngine(traced_cpu, cpu_params, scfg, eos_id=-1,
                          device=cpu)
    traced_cpu.engine = eng_cpu
    cpu_reqs = {}
    for r in reqs:
        if r.rid in traced.recorded:
            cpu_reqs[r.rid] = Request(rid=r.rid,
                                      prompt_tokens=list(r.prompt_tokens),
                                      max_new_tokens=MAX_NEW,
                                      priority=r.priority)
            eng_cpu.submit(cpu_reqs[r.rid])
    eng_cpu.run_until_drained()
    streams = compare_streams({r.rid: r for r in done}, traced.logits,
                              cpu_reqs, traced_cpu.logits)
    result["cpu_check"] = {"requests": len(cpu_reqs), "near_tie": NEAR_TIE,
                           "seconds": time.perf_counter() - t0,
                           "streams": streams}
    del eng_cpu, traced_cpu, cpu_params
    t0 = time.perf_counter()
    result["f32_check"] = f32_check(model, scfg, tree, tree_cpu,
                                    longest_short, dev)
    result["f32_check"]["seconds"] = time.perf_counter() - t0
    return result


def f32_check(model, scfg, tree_card, tree_cpu, prompt, dev) -> dict:
    """The same weights in f32 behind two ServeEngines, on the CPU and on
    the card, with f32 caches and a clock that stands still (admission by
    finished count only): the F32_REQUESTS fill all eight slots, two finish
    early and two more are admitted into their used slots.  The CPU decodes
    greedily; the card is fed the CPU's tokens.  Free of bf16 rounding,
    every step's logits must agree up to f32 sums taken in other orders;
    the largest gap is reported against the logits' scale."""
    from repro_torch.serve.engine import Request, ServeEngine
    prompts = {tuple(prompt[:n]): rid
               for rid, (n, _) in enumerate(F32_REQUESTS)}
    check(len(prompts) == len(F32_REQUESTS), "f32 check prompts distinct")
    sides = []
    follow = None
    for tree, d in ((tree_cpu, torch.device("cpu")), (tree_card, dev)):
        params = model.params_from_tree(_tree_map(lambda t: t.float(), tree))
        traced = Traced(model, d, prompts, follow=follow,
                        cache_dtype=torch.float32)
        eng = ServeEngine(traced, params, scfg, eos_id=-1,
                          clock=lambda: 0.0, device=d)
        traced.engine = eng
        for rid, (n, new) in enumerate(F32_REQUESTS):
            check(eng.submit(Request(rid=rid, prompt_tokens=list(prompt[:n]),
                                     max_new_tokens=new)),
                  f"f32 request {rid} refused")
        done = {r.rid: r.output_tokens for r in eng.run_until_drained()}
        check(len(done) == len(F32_REQUESTS), "f32 check: every request done")
        sides.append((traced.logits, done, traced.live))
        follow = done                     # the card follows the CPU
        del eng, params
    (cpu_logits, cpu_done, live), (card_logits, card_done, card_live) = sides
    check(card_done == cpu_done and card_live == live,
          "f32 check: the card followed the CPU")
    check(max(live) == scfg.max_batch, f"f32 check: live slots {live}")
    worst, scale, rows, own = 0.0, 0.0, 0, 0
    for rid, toks in cpu_done.items():
        check(len(cpu_logits[rid]) == len(card_logits[rid]) == len(toks),
              f"f32 check: request {rid} kept one row per token")
        for c, g, t in zip(cpu_logits[rid], card_logits[rid], toks):
            worst = max(worst, float((c - g).abs().max()))
            scale = max(scale, float(c.abs().max()))
            own += int(g.argmax()) == t
            rows += 1
    return {"requests": len(F32_REQUESTS), "slots": scfg.max_batch,
            "live_slots_per_step": live, "rows": rows, "card_argmax_equal": own,
            "max_logit_gap": worst, "logit_scale": scale,
            "relative_gap": worst / scale}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile_decode(eng, reqs) -> dict:
    """Device busy share of steady decode with every slot full: the
    requests are admitted and prefilled by one step, then PROFILED_STEPS
    decode steps run under torch.profiler; the kernels' device time over
    the window's wall time (the profiler's own host cost included)."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        check(eng.submit(r), "profiled request refused")
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    eng.run_until_drained()
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    return {"steps": PROFILED_STEPS, "active_slots": len(reqs),
            "wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if busy else "not measured",
            "top_kernels_ms": [[e.key[:80], _device_us(e) / 1e3, e.count]
                               for e in top]}


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    return fn(node)


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
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.window_reduce import (window_reduce,
                                                   window_reduce_plain)
    from repro_torch.query import AggQuery, QueryPlane
    from repro_torch.store import ReplayEngine, StorePlane

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in f32, as the reference's dots accumulate
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES, pool.map(build.build,
                                                  KERNEL_SOURCES)))
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(KERNEL_SOURCES),
         ptxas={name: [ln.strip() for ln in lines
                       if "Used" in ln or "entry function" in ln]
                for name, lines in built.items()})

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
        emit("replay", sources=SOURCES, cut=CUT, events=n_events,
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

    # 7. flash_attention's contract, then its times at the prefill shapes
    flash = flash_contract_cases(flash_attention, flash_attention_plain, dev)
    emit("flash_kernel", tol={str(k): v for k, v in FLASH_TOL.items()},
         **flash)
    flash_times = flash_timing(flash_attention, flash_attention_plain, dev)
    emit("flash_timing", card=smi, shapes=flash_times)

    # 8. serve: Qwen2.5-3B through ServeEngine on the card, checked on CPU
    serve = serve_phase(args.seed, dev, flash_attention)
    emit("serve", **serve)
    check(serve["f32_check"]["relative_gap"] <= F32_TOL,
          f"f32 card vs CPU logits: {serve['f32_check']}")
    for rid, row in serve["cpu_check"]["streams"].items():
        check(row["equal"] or row["near_tie"],
              f"request {rid}: card and CPU streams part at token "
              f"{row['first_diff']} with margin {row.get('margin')} above "
              f"the near-tie tolerance {row.get('tolerance')}")

    # 9. kernels
    main_shape = timing["channel_day"]
    flash_main = flash_times[FLASH_TIMED_S[-1]]
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
        "shape": "channel_day",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": serve["flash_attention_launches"],
        "max_abs_err": max(flash["max_abs_err"].values()),
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "shape": f"B=1 S={FLASH_TIMED_S[-1]} Hq=16 Hkv=2 D=128 bf16 causal",
    }]}), flush=True)
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
