"""stablelm-3b [dense] — MHA (GQA kv=32). [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    head_dim=80,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=176,
    vocab=512,
    head_dim=16,
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=1, model_axis_role="dp"),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
