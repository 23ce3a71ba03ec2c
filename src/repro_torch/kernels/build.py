"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so one nvcc call compiles it in seconds.  A source is compiled at first
use for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` beside this
module, where ``<hash>`` covers the source and the flags: an unchanged
source reuses its library, an edited one gets a new file.  Nothing is
built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are compiled with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> List[str]:
    """Compile ``csrc/<name>.cu`` unless its library is current.
    -> nvcc's ``ptxas`` lines (empty when the library was already built)."""
    so = library_path(name)
    if so.exists():
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, so)                  # atomic: a reader never sees half
    return [ln for ln in proc.stdout.splitlines() if "ptxas" in ln]


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if
    needed.  Each kernel's wrapper loads once and keeps the handle."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
