"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]

16 experts divide the 16-way model axis exactly -> expert parallelism.
"""
from repro_torch.config import ModelConfig, MoEConfig, ParallelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=4, sharding="ep"),
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=4, sharding="ep"),
)

PARALLEL = {
    "train_4k": ParallelConfig(
        microbatches=4, optimizer_dtype="bfloat16", grad_accum_dtype="bfloat16"
    ),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
