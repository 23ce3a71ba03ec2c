"""internvl2-26b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

The InternViT frontend is a STUB: input_specs() provides precomputed
patch embeddings (256 positions after pixel-shuffle, width 3200) that a
learned projector maps to d_model and prepends to the token embeddings.
"""
from repro_torch.config import FrontendConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="patch", num_positions=256, embed_dim=3200),
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=16,
    frontend=FrontendConfig(kind="patch", num_positions=8, embed_dim=48),
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=4),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
