"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

54 Mamba2 layers; ONE shared transformer block (attn + MLP) applied every
6 SSM layers (9 invocations, weights reused — Zamba2's signature trick).
At long context (long_500k) the shared attention falls back to a 4096
sliding window, which keeps the arch sub-quadratic (DESIGN.md
§Arch-applicability).
"""
from repro_torch.config import ModelConfig, ParallelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
    hybrid_attn_every=6,
    hybrid_attn_window=4096,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=32),
    hybrid_attn_every=2,
    hybrid_attn_window=64,
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=1, model_axis_role="dp"),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(decode_cache_shard="heads"),
}
