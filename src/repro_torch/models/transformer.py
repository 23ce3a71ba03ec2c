"""Dense decoder transformer: parameter defs, module state, prefill and
decode.

The port's counterpart of ``repro/models/transformer.py`` for the
``dense`` family, forward only.  The JAX package stacks the blocks along
a leading ``n_layers`` dim and scans them; here each block is its own
``nn.Module`` and a Python loop walks them.  The mesh plumbing of the
reference (``shard(...)``, ``get_parallel``, remat) is identity on one
card and is dropped.  Weights keep the reference's dtypes; projections
are ``nn.Linear`` (weight ``(out, in)``, the qkv bias as its ``bias``).

Every prefill attention runs the hand-written kernel once per layer
(``layers.flash_attention``); decode attention is plain torch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.param import ParamDef

# block projections: reference name -> the name of its bias (or None)
LINEARS = {"wq": "bq", "wk": "bk", "wv": "bv", "wo": None,
           "w_gate": None, "w_up": None, "w_down": None}


def padded_vocab(vocab: int, model_axis: int = 16) -> int:
    if vocab < 8192 or vocab % model_axis == 0:
        return vocab
    mult = 128 * model_axis
    return -(-vocab // mult) * mult


# ---------------------------------------------------------------------------
# Parameter definitions (the reference's tree, shared by both packages)
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, nl: int) -> Dict[str, Any]:
    """Stacked defs for `nl` transformer blocks (attn + mlp)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP A10, kernel B5)")
    d = cfg.d_model
    h = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    block: Dict[str, Any] = {
        "ln1": ParamDef((nl, d), ("layers", None), init="ones"),
        "wq": ParamDef((nl, d, hq * h), ("layers", "embed", "heads"), init="fan_in", scale=1.0),
        "wk": ParamDef((nl, d, hkv * h), ("layers", "embed", "heads"), init="fan_in", scale=1.0),
        "wv": ParamDef((nl, d, hkv * h), ("layers", "embed", "heads"), init="fan_in", scale=1.0),
        "wo": ParamDef((nl, hq * h, d), ("layers", "heads", "embed"), init="fan_in", scale=1.0),
        "ln2": ParamDef((nl, d), ("layers", None), init="ones"),
    }
    if cfg.qkv_bias:
        block["bq"] = ParamDef((nl, hq * h), ("layers", "heads"), init="zeros")
        block["bk"] = ParamDef((nl, hkv * h), ("layers", "heads"), init="zeros")
        block["bv"] = ParamDef((nl, hkv * h), ("layers", "heads"), init="zeros")
    block["w_gate"] = ParamDef((nl, d, cfg.d_ff), ("layers", "embed", "ff"), init="fan_in", scale=1.0)
    block["w_up"] = ParamDef((nl, d, cfg.d_ff), ("layers", "embed", "ff"), init="fan_in", scale=1.0)
    block["w_down"] = ParamDef((nl, cfg.d_ff, d), ("layers", "ff", "embed"), init="fan_in", scale=1.0)
    return block


def transformer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    vp = padded_vocab(cfg.vocab)
    defs: Dict[str, Any] = {
        "blocks": block_defs(cfg, cfg.n_layers),
        "ln_f": ParamDef((d,), (None,), init="ones"),
    }

    if cfg.frontend.kind == "frame":
        defs["frame_proj"] = ParamDef((cfg.frontend.embed_dim, d), (None, "embed"), init="fan_in", scale=1.0)
        defs["mask_emb"] = ParamDef((d,), (None,), init="normal")
        defs["lm_head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"), init="fan_in", scale=1.0)
        return defs

    defs["embed_tokens"] = ParamDef((vp, d), (None, "embed_tp"), init="normal")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, vp), ("embed", "vocab"), init="fan_in", scale=1.0)
    if cfg.frontend.kind == "patch":
        defs["patch_proj"] = ParamDef((cfg.frontend.embed_dim, d), (None, "embed"), init="fan_in", scale=1.0)
    return defs


# ---------------------------------------------------------------------------
# Module state
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _linear(w: torch.Tensor, b: Optional[torch.Tensor]) -> nn.Linear:
    """nn.Linear holding the reference's (in, out) weight ``w``
    transposed to (out, in), and bias ``b``; allocates nothing else."""
    lin = nn.Linear(w.shape[0], w.shape[1], bias=b is not None,
                    device="meta")
    lin.weight = _frozen(w.t().contiguous())
    if b is not None:
        lin.bias = _frozen(b)
    return lin


class Block(nn.Module):
    """One transformer block: ln1, wq/wk/wv (with bq/bk/bv as biases),
    wo, ln2, w_gate/w_up/w_down."""

    def __init__(self, tree: Dict[str, torch.Tensor]):
        super().__init__()
        self.ln1 = _frozen(tree["ln1"])
        self.ln2 = _frozen(tree["ln2"])
        for name, bias in LINEARS.items():
            setattr(self, name, _linear(tree[name], tree.get(bias)))

    def to_tree(self) -> Dict[str, torch.Tensor]:
        out = {"ln1": self.ln1.data, "ln2": self.ln2.data}
        for name, bias in LINEARS.items():
            lin = getattr(self, name)
            out[name] = lin.weight.data.t()
            if bias is not None and lin.bias is not None:
                out[bias] = lin.bias.data
        return out


class TransformerParams(nn.Module):
    """The dense model's weights: ``embed_tokens`` (Vp, d), ``blocks``,
    ``ln_f`` and, unless tied, ``lm_head`` (an nn.Linear, (Vp, d))."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        if cfg.frontend.kind != "none":
            raise NotImplementedError(
                f"the {cfg.frontend.kind!r} frontend is not ported yet "
                f"(ROADMAP A11)")
        self.embed_tokens = _frozen(tree["embed_tokens"])
        stacked = tree["blocks"]
        self.blocks = nn.ModuleList(
            Block({k: v[i] for k, v in stacked.items()})
            for i in range(cfg.n_layers))
        self.ln_f = _frozen(tree["ln_f"])
        self.lm_head = (None if cfg.tie_embeddings
                        else _linear(tree["lm_head"], None))

    def to_tree(self) -> Dict[str, Any]:
        """The reference's layout again: blocks stacked, (in, out)."""
        per_layer = [blk.to_tree() for blk in self.blocks]
        tree = {"blocks": {k: torch.stack([p[k] for p in per_layer])
                           for k in per_layer[0]},
                "ln_f": self.ln_f.data,
                "embed_tokens": self.embed_tokens.data}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head.weight.data.t()
        return tree


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(cfg: ModelConfig, bp: Block, xn: torch.Tensor,
         positions: torch.Tensor):
    h = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    b, s, _ = xn.shape
    q = bp.wq(xn).reshape(b, s, hq, h)           # nn.Linear adds bq etc.
    k = bp.wk(xn).reshape(b, s, hkv, h)
    v = bp.wv(xn).reshape(b, s, hkv, h)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg: ModelConfig, bp: Block, x: torch.Tensor,
                    positions: torch.Tensor, *, window: int = 0):
    """Full-sequence attention (prefill).  Returns (x, k, v) so the
    prefill path can collect the KV cache; k and v are not repeated."""
    xn = L.rms_norm(x, bp.ln1, cfg.norm_eps)
    q, k, v = _qkv(cfg, bp, xn, positions)
    o = L.flash_attention(q, k, v, causal=cfg.causal, window=window)
    b, s, _, _ = o.shape
    x = x + bp.wo(o.reshape(b, s, -1))
    return x, k, v


def mlp_block(cfg: ModelConfig, bp: Block, x: torch.Tensor) -> torch.Tensor:
    xn = L.rms_norm(x, bp.ln2, cfg.norm_eps)
    return x + L.swiglu(xn, bp.w_gate, bp.w_up, bp.w_down)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params: TransformerParams,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return F.embedding(batch["tokens"], params.embed_tokens)


def lm_logits(cfg: ModelConfig, params: TransformerParams,
              x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params.ln_f, cfg.norm_eps)
    if params.lm_head is not None:
        return params.lm_head(x)
    return F.linear(x, params.embed_tokens)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _blocks(cfg: ModelConfig, params: TransformerParams, x: torch.Tensor, *,
            collect_cache: bool, window: int):
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    ks, vs = [], []
    for bp in params.blocks:
        x, k, v = attention_block(cfg, bp, x, positions, window=window)
        x = mlp_block(cfg, bp, x)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_cache else None
    return x, cache


def forward(cfg: ModelConfig, params: TransformerParams,
            batch: Dict[str, torch.Tensor], *, collect_cache: bool = False,
            window: int = 0):
    """Returns (logits (B, S, Vp), aux_loss, cache | None); the dense
    family's aux loss is 0."""
    x = embed_inputs(cfg, params, batch)
    x, cache = _blocks(cfg, params, x, collect_cache=collect_cache,
                       window=window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(cfg, params, x), aux, cache


def prefill(cfg: ModelConfig, params: TransformerParams,
            batch: Dict[str, torch.Tensor], *, window: int = 0):
    """Returns (last_logits (B, Vp), cache with per-layer K/V
    (L, B, S, Hkv, D) and pos (B,)).  Only the last position goes through
    the head: row for row it is ``forward``'s last logits."""
    x = embed_inputs(cfg, params, batch)
    x, cache = _blocks(cfg, params, x, collect_cache=True, window=window)
    last = lm_logits(cfg, params, x[:, -1:])[:, 0]
    b, s = batch["tokens"].shape
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return last, cache


def decode_step(cfg: ModelConfig, params: TransformerParams,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) int; cache holds (L, B, S, Hkv, D)
    K/V plus pos (B,).  The cache is CIRCULAR: writes land at pos % S, so
    a cache allocated at window size implements sliding-window decode.
    The new K/V rows are written into ``cache`` in place (the reference
    returns a new cache).  Attention reads only the first
    max(min(pos + 1, S)) positions: the rest are masked for every row, so
    the result is the reference's.  Returns (logits (B, Vp), cache)."""
    pos = cache["pos"]
    x = F.embedding(tokens, params.embed_tokens)          # (B, 1, d)
    h = cfg.resolved_head_dim
    b = tokens.shape[0]
    s_cache = cache["k"].shape[2]
    slot = (pos % s_cache).long()
    rows = torch.arange(b, device=pos.device)
    length = torch.clamp(pos + 1, max=s_cache)
    live = int(length.max())
    for i, bp in enumerate(params.blocks):
        kc, vc = cache["k"][i], cache["v"][i]             # (B, S, Hkv, D)
        xn = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        q, k, v = _qkv(cfg, bp, xn, pos[:, None])
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        o = L.decode_attention(q, kc[:, :live], vc[:, :live], length)
        x = x + bp.wo(o.reshape(b, 1, cfg.n_heads * h))
        x = mlp_block(cfg, bp, x)
    logits = lm_logits(cfg, params, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    h = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, h)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }
