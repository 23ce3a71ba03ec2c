"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

d_inner = 2 * d_model = 4096, 64 SSD heads of dim 64, state 128.
Decode state is O(1) in sequence length, so all decode shapes (incl.
long_500k) run natively.
"""
from repro_torch.config import ModelConfig, ParallelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,          # SSD heads (d_inner / head_dim)
    n_kv_heads=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=8,
    d_ff=0,
    vocab=256,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=32),
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=1, model_axis_role="dp"),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="heads"),
    "long_500k": ParallelConfig(decode_cache_shard="heads"),
}
