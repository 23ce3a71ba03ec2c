"""internlm2-20b [dense] — GQA. [arXiv:2403.17297; hf]"""
from repro_torch.config import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    head_dim=128,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=16,
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=2),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
