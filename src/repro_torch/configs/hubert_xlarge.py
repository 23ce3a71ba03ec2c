"""hubert-xlarge [audio] — encoder-only, w2v2 arch. [arXiv:2106.07447; unverified]

The CNN waveform frontend is a STUB: input_specs() provides precomputed
frame embeddings (width 512) projected to d_model.  Training objective is
masked-unit prediction over 504 cluster codes (encoder-only => no decode
shapes; skip recorded in DESIGN.md).
"""
from repro_torch.config import FrontendConfig, ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,
    frontend=FrontendConfig(kind="frame", embed_dim=512),
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=32,
    head_dim=16,
    causal=False,
    frontend=FrontendConfig(kind="frame", embed_dim=24),
)

PARALLEL = {
    "train_4k": ParallelConfig(microbatches=1, model_axis_role="dp"),
    "prefill_32k": ParallelConfig(),
    "decode_32k": ParallelConfig(),
    "long_500k": ParallelConfig(),
}
