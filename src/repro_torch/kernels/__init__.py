"""repro_torch.kernels — hand-written Hopper kernels and their wrappers.

  window_reduce   per-(key, window) count / sum / sumsq / max, the alerts
                  stage's batch reduction (csrc/window_reduce.cu)
  build           nvcc + ctypes loader for csrc/*.cu

A wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA card is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    return dev
