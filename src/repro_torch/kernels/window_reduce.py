"""Per-segment count / sum / sum-of-squares / max — the alerts stage's
batch reduction (a segment is one flattened (key, window) slot).

Counterpart of the JAX package's ``kernels/window_reduce.py::
window_reduce_fwd`` (the TPU kernel), ``kernels/ops.py::window_reduce``
(its wrapper's contract) and ``kernels/ref.py::window_reduce_ref`` (its
oracle).  The contract:

  values  (N,) f32    event values
  seg_ids (N,) i32    segment id per event; ids outside [0, S) — the -1
                      padding among them — are ignored
  ->      (S, 4) f32  count, sum, sumsq, max; an empty segment reports
                      count 0 and max -inf

``window_reduce`` launches the CUDA kernel in ``csrc/window_reduce.cu``
(design and bound in its header) for CUDA tensors and runs
``window_reduce_plain`` for CPU tensors.  The kernel's float sums are
taken in another order than the plain version's, so the two agree to a
tolerance, not bit for bit; count and max agree exactly.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, resolve_device

_MAX_EVENTS = 2**31 - 2**14          # int32 offsets, one tile of headroom
_MAX_SEGMENTS = 2**31 - 2            # the sentinel key S must fit int32


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("window_reduce")
    p = ctypes.c_void_p
    lib.window_reduce_launch.argtypes = [
        p, p, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p]
    lib.window_reduce_launch.restype = ctypes.c_int
    lib.window_reduce_tile.argtypes = []
    lib.window_reduce_tile.restype = ctypes.c_int
    return lib


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """Tensors stay where they lie (and must already have the dtype);
    anything else is cast to numpy ``dtype`` and moved to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(np.asarray(x, dtype=dtype))
    return torch.from_numpy(arr).to(resolve_device(device))


def window_reduce(values, seg_ids, num_segments: int, *,
                  device="cuda") -> torch.Tensor:
    """(num_segments, 4) f32 on the inputs' device: count, sum, sumsq, max.

    numpy (or list) inputs are moved to ``device``; tensors are used where
    they lie.  N = 0 returns the empty-segment lanes without a launch."""
    values = _as_tensor(values, np.float32, device)
    seg_ids = _as_tensor(seg_ids, np.int32, device)
    if values.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise TypeError(f"window_reduce takes f32 values and i32 seg_ids, "
                        f"got {values.dtype} and {seg_ids.dtype}")
    if values.dim() != 1 or values.shape != seg_ids.shape:
        raise ValueError(f"values and seg_ids must be 1-D of one length, "
                         f"got {tuple(values.shape)} and "
                         f"{tuple(seg_ids.shape)}")
    if values.device != seg_ids.device:
        raise ValueError(f"values on {values.device}, seg_ids on "
                         f"{seg_ids.device}")
    if not 0 <= num_segments <= _MAX_SEGMENTS:
        raise ValueError(f"num_segments out of range: {num_segments}")
    n = values.shape[0]
    if n == 0 or num_segments == 0:      # nothing to reduce: no launch
        out = torch.zeros((num_segments, 4), dtype=torch.float32,
                          device=values.device)
        out[:, 3] = float("-inf")
        return out
    if values.device.type == "cpu":
        return window_reduce_plain(values, seg_ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"window_reduce runs on CUDA or CPU tensors, "
                         f"not {values.device}")
    if n > _MAX_EVENTS:
        raise ValueError(f"{n} events exceed the kernel's {_MAX_EVENTS}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("window_reduce's kernel takes contiguous tensors")
    return _launch(values, seg_ids, num_segments)


window_reduce.launches = 0           # kernel launches, counted in _launch


def _launch(values: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    lib = _kernel_lib()
    n = values.shape[0]
    dev = values.device
    tiles = -(-n // lib.window_reduce_tile())
    keys = torch.empty(2 * n, dtype=torch.int32, device=dev)
    vals = torch.empty(2 * n, dtype=torch.float32, device=dev)
    hist = torch.empty(256 * tiles + 256, dtype=torch.int32, device=dev)
    bounds = torch.empty(2 * num_segments, dtype=torch.int32, device=dev)
    out = torch.empty((num_segments, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_reduce_launch(
            values.data_ptr(), seg_ids.data_ptr(), n, num_segments,
            keys.data_ptr(), vals.data_ptr(), hist.data_ptr(),
            bounds.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"window_reduce kernel launch failed: CUDA "
                           f"error {rc}")
    window_reduce.launches += 1
    return out


def window_reduce_plain(values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Plain PyTorch version, on any device: ``index_add_`` for the
    count / sum / sumsq lanes, ``scatter_reduce_(amax)`` for max."""
    valid = (seg_ids >= 0) & (seg_ids < num_segments)
    sid = seg_ids[valid].long()
    v = values[valid]
    sums = torch.zeros((num_segments, 3), dtype=torch.float32,
                       device=values.device)
    sums.index_add_(0, sid, torch.stack([torch.ones_like(v), v, v * v], 1))
    mx = torch.full((num_segments,), float("-inf"), dtype=torch.float32,
                    device=values.device)
    mx.scatter_reduce_(0, sid, v, reduce="amax", include_self=True)
    return torch.cat([sums, mx[:, None]], dim=1)
