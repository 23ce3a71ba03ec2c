"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    head_dim=16,
    qkv_bias=True,
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=1, model_axis_role="dp"),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
