"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1; unverified]

8 experts do not divide the 16-way model axis; EXPERT SPLITTING makes
them: swiglu FFNs are separable over d_ff, so each expert is stored as
two half-experts of d_ff 16384 (algebraically exact — see
tests/test_moe.py::test_expert_splitting_exact_equivalence), giving 16
virtual experts that shard 1:1 over the model axis (true EP, a2a
dispatch instead of a TP psum).
"""
from repro_torch.config import ModelConfig, MoEConfig, ParallelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, sharding="ep", split_factor=2),
)

SMOKE = ModelConfig(
    name="grok1-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2, sharding="tp"),
)

PARALLEL = {
    "train_4k": ParallelConfig(
        microbatches=4, optimizer="adafactor",
        optimizer_dtype="float32", grad_accum_dtype="bfloat16",
        offload_optimizer=True,   # split update phase: peak = max(phases)
    ),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(decode_cache_shard="seq"),
    "long_500k": ParallelConfig(),
}
