"""repro_torch — the PyTorch + CUDA port of the AlertMix reproduction.

The JAX package ``repro`` stays the reference; this package mirrors its
layout and names, imports nothing of it, and runs its kernels by hand on
Hopper.  Two slices are ported: the durable read path (event log ->
replay -> alert rules -> materialized store -> cold query, through the
``window_reduce`` kernel) and the serving path (request admission ->
prefill through the ``flash_attention`` kernel -> batched decode against
a KV cache -> greedy tokens, for the dense transformer family).

  alerts    windows, rules, AnalyticsStage, the batch packers/reducers
  store     EventLog, ColumnarEventLog, DeadLetterJournal, ReplayEngine,
            StorePlane
  query     MaterializedStore, QueryEngine, QueryPlane
  serve     ServeEngine, Request (launch/serve.py drives it)
  models    dense transformer: param defs + init + weight bridge, layers,
            prefill / decode
  config    ModelConfig, ServeConfig, ...; configs: the arch registry
  kernels   window_reduce and flash_attention (csrc/*.cu) and their
            nvcc/ctypes build
  core      DedupWindow, BoundedPriorityQueue, DeadLettersListener
  delivery  Sink, SubscriptionHub
  data      HashTokenizer
  obs       StageProfiler

Every entry point takes ``device`` (default ``"cuda"``); with no card a
CUDA device raises, it never runs on the CPU instead.  Pass
``device="cpu"`` for the plain PyTorch path.
"""
