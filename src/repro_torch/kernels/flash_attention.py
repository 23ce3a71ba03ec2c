"""Online-softmax attention with causal / sliding-window masks and
zero-copy grouped-query attention — the prefill attention of every dense
transformer layer.

Counterpart of the JAX package's ``kernels/flash_attention.py::
flash_attention_fwd`` (the TPU kernel) and ``kernels/ref.py::
attention_ref`` (its oracle).  The contract:

  q       (B, S, Hq, D)   f32 or bf16, contiguous
  k, v    (B, S, Hkv, D)  q's dtype; Hq a multiple of Hkv; query head h
                          reads kv head h // (Hq // Hkv) (no repeated K/V)
  causal  key position <= query position
  window  if > 0, query position - key position < window
  ->      (B, S, Hq, D) in q's dtype

Scores are f32 (q and k cast up), scaled by 1/sqrt(D); masked scores are
-1e30 and weigh 0; p is rounded to v's dtype before the P.V product, as
the TPU kernel's ``p.astype(v.dtype)``; the sum is f32 and its
normaliser is clamped at 1e-30.  Every S >= 1 is taken and D is a
multiple of 8 up to 128.

``flash_attention`` launches the CUDA kernel in
``csrc/flash_attention.cu`` (design and bound in its header) for CUDA
tensors and runs ``flash_attention_plain`` for CPU tensors.  The kernel
folds its softmax tile by tile and the plain version over the whole row,
so the two agree to a tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           i, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, Hq, D) and k, v (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         f"kv heads")
    if d % 8 != 0 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d}: must be a multiple of 8 in "
                         f"[8, 128]")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, Hq, D) attention output in q's dtype, on q's device."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel takes contiguous tensors")
    out = torch.empty_like(q)
    if q.numel() == 0:                   # B = 0 or S = 0: nothing to launch
        return out
    return _launch(q, k, v, out, causal, window)


flash_attention.launches = 0         # kernel launches, counted in _launch


def _launch(q, k, v, out, causal: bool, window: int) -> torch.Tensor:
    lib = _kernel_lib()
    b, s, hq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, k.shape[2], d, int(bool(causal)), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain PyTorch version, on any device: the whole (S, S) score matrix
    per head, one softmax per row, the same masks and roundings."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (
        1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window and window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = acc / denom.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, hq, d).to(q.dtype)
