"""Shared neural layers, forward only: RMSNorm, RoPE, prefill attention
through the hand-written kernel, decode attention, SwiGLU MLP.

The port's counterparts of ``repro/models/layers.py``, with the same
numerics: norms and rotations in f32 and cast back, attention scores in
f32, bf16 products elsewhere.  ``flash_attention`` takes UNREPEATED K/V
and hands them to ``repro_torch.kernels.flash_attention``, whose kernel
maps query head h to kv head h // (Hq // Hkv) (zero-copy GQA), the order
``repeat_kv`` gives; the JAX package repeats K/V first and runs its
triangle-pair scan.  ``decode_attention`` stays plain torch, as the
reference computes it outside any kernel.  The training pieces
(``softmax_cross_entropy``, ``embed_lookup``'s backward) arrive with the
training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_inv_freq(head_dim: int, theta: float,
                  device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The
    rotation is half-split (x1 = first D/2, x2 = last D/2), angles f32."""
    d = x.shape[-1]
    inv = rope_inv_freq(d, theta, device=x.device)          # (D/2,)
    ang = positions[..., None].float() * inv                # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D), each kv head n_rep times
    in a row."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention. q: (B, S, Hq, D); k, v: (B, S, Hkv, D), NOT
    repeated.  Returns (B, S, Hq, D) in q.dtype."""
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One new token against a KV cache.  q: (B, 1, H, D); caches
    (B, S, Hkv, D); length (B,) valid cache positions.  Invalid positions
    score -inf.  The query heads are grouped over their kv head instead
    of repeating the cache; the sums are the same."""
    b, s, hkv, d = k_cache.shape
    h = q.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, d).float()
    sco = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)[None, :]          # (1, S)
    valid = pos < length[:, None]
    if window and window > 0:
        valid = valid & (pos >= (length[:, None] - window))
    sco = sco.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(sco, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU MLP over ``nn.Linear`` projections: silu of the gate in f32,
    cast back, times the up projection, then down."""
    g = w_gate(x)
    u = w_up(x)
    h = F.silu(g.float()).to(x.dtype) * u
    return w_down(h)
