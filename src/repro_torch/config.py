"""Configuration system for AlertMix-JAX.

Every architecture is described by a :class:`ModelConfig`; every workload
shape by a :class:`ShapeConfig`; every mesh by a :class:`MeshConfig`.  A
(model, shape, mesh) triple fully determines what the launcher lowers.

All configs are plain dataclasses so they can be serialized into
checkpoints and compared structurally in tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (token-choice top-k with capacity)."""

    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "ep": experts sharded over the model axis (requires num_experts %
    #       model_axis == 0); "tp": d_ff sharded over the model axis.
    sharding: str = "ep"
    # expert splitting: swiglu FFNs are separable over d_ff, so each
    # expert can be stored as `split_factor` half-experts of d_ff/r —
    # making num_experts*r divide the model axis (EP for grok-1's 8
    # experts on a 16-way axis). Routing stays on PARENT experts; each
    # selected parent dispatches the token to all r children with the
    # same gate (their partial outputs sum to the original FFN exactly).
    split_factor: int = 1
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01

    @property
    def virtual_experts(self) -> int:
        return self.num_experts * self.split_factor


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: precomputed embeddings are model inputs.

    kind: "none" (text), "patch" (VLM: precomputed patch embeddings are
    prepended to the token embeddings), "frame" (audio: precomputed frame
    embeddings replace the token embeddings entirely).
    """

    kind: str = "none"
    num_positions: int = 0          # patches per image / frames handled upstream
    embed_dim: int = 0              # incoming embedding width (projected to d_model)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    causal: bool = True             # False => encoder-only (audio)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # hybrid (zamba2-style): a single SHARED attention+MLP block applied
    # every `hybrid_attn_every` SSM layers.
    hybrid_attn_every: int = 0
    hybrid_attn_window: int = 0     # sliding window used at long context (0 = full)
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # long-context attention: queries are processed in chunks of this size
    # with an online-softmax scan over KV chunks (jnp flash attention).
    attn_chunk: int = 1024
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode?  SSM and hybrid (whose
        attention falls back to a sliding window at long context) can."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj: z, x, B, C, dt
            per_layer += d * (2 * d_in + 2 * s.state_dim + nheads)
            per_layer += s.conv_width * (d_in + 2 * s.state_dim)  # conv over x,B,C
            per_layer += nheads * 2                                # A_log, D
            per_layer += nheads                                    # dt_bias
            per_layer += d_in * d                                  # out_proj
            per_layer += d                                         # norm
            total = emb + head + self.n_layers * per_layer + d
            return total
        attn = d * nq * h + 2 * d * nkv * h + nq * h * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * h
        if self.moe is not None:
            ff = self.moe.num_experts * 3 * d * self.d_ff + d * self.moe.num_experts
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            ssm_layer = (
                d * (2 * d_in + 2 * s.state_dim + nheads)
                + s.conv_width * (d_in + 2 * s.state_dim)
                + nheads * 3
                + d_in * d
                + d
            )
            n_shared = max(1, self.n_layers // max(1, self.hybrid_attn_every))
            # one shared transformer block, invoked n_shared times
            return emb + head + self.n_layers * ssm_layer + per_layer + d
        return emb + head + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        ff_all = self.n_layers * self.moe.num_experts * 3 * d * self.d_ff
        ff_active = self.n_layers * self.moe.top_k * 3 * d * self.d_ff
        return full - ff_all + ff_active


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_supported(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Applicability rules (documented in DESIGN.md §Arch-applicability)."""
    if shape.kind == "decode" and model.encoder_only:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; this arch is pure "
            "full-attention (skip noted in DESIGN.md)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description.

    Axes: ("pod", "data", "model") multi-pod or ("data", "model") single.
    - batch is sharded over (pod, data)
    - weights are FSDP-sharded over data and tensor-sharded over model
    - sequence parallelism shards activation seq over model between blocks
    """

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def fsdp_axis(self) -> str:
        return "data"

    @property
    def model_axis(self) -> str:
        return "model"

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)]


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class ParallelConfig:
    """Per-(arch x shape) knobs the perf loop iterates on."""

    microbatches: int = 1           # grad-accumulation steps inside train_step
    model_axis_role: str = "tp"     # tp | dp: small archs can repurpose the
                                    # 16-way model axis as extra data
                                    # parallelism (no TP collectives)
    optimizer: str = "adamw"        # adamw | adafactor (factored 2nd moment)
    remat_policy: str = "minimal"   # minimal | dots | full | none
    sequence_parallel: bool = True  # shard activation seq over model axis
    optimizer_dtype: str = "float32"  # adamw moment dtype (bf16 halves memory)
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator dtype
    grad_compression: str = "none"  # none | int8 (ring all-reduce, error feedback)
    decode_cache_shard: str = "seq"  # seq | heads: KV cache sharding over model
    moe_impl: str = "shard_map"     # shard_map (local dispatch + explicit
                                    # collectives) | xla (auto-partitioned)
    scan_layers: bool = True
    offload_optimizer: bool = False


# ---------------------------------------------------------------------------
# Training / data / serving configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | linear | constant


@dataclass(frozen=True)
class DataConfig:
    """AlertMix streaming data-plane settings (paper §Proposed approach)."""

    num_sources: int = 1024         # streams in the registry
    pick_interval_s: float = 300.0  # scheduler tick (paper: 5 minutes)
    queue_capacity: int = 4096      # bounded mailbox size (backpressure)
    priority_levels: int = 3
    optimal_buffer: int = 256       # FeedRouter replenish-to-optimal target
    replenish_after: int = 64       # trigger (b): fetch after N processed
    replenish_timeout_s: float = 1.0  # trigger (c)
    worker_pool_size: int = 8
    resizer_enabled: bool = True    # OptimalSizeExploringResizer
    dedup_window: int = 1 << 16     # recent-content-hash window
    seq_len: int = 2048
    micro_batch: int = 8


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 32             # decode batch slots (continuous batching)
    max_seq_len: int = 2048
    queue_capacity: int = 1024
    replenish_after: int = 4        # FeedRouter logic on the request router
    replenish_timeout_s: float = 0.05
    max_new_tokens: int = 64


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
