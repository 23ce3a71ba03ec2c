"""repro_torch — the PyTorch + CUDA port of the AlertMix reproduction.

The JAX package ``repro`` stays the reference; this package mirrors its
layout and names, imports nothing of it, and runs its kernels by hand on
Hopper.  This slice carries the durable read path: event log -> replay ->
alert rules -> materialized store -> cold query, through the
``window_reduce`` kernel.

  alerts   windows, rules, AnalyticsStage, the batch packers/reducers
  store    EventLog, ColumnarEventLog, DeadLetterJournal, ReplayEngine,
           StorePlane
  query    MaterializedStore, QueryEngine, QueryPlane
  kernels  window_reduce (csrc/window_reduce.cu) and its nvcc/ctypes build
  obs      StageProfiler
  core     DedupWindow

Every entry point takes ``device`` (default ``"cuda"``); with no card a
CUDA device raises, it never runs on the CPU instead.  Pass
``device="cpu"`` for the plain PyTorch path.
"""
