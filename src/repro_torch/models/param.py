"""Parameter definitions, random initialisation and the weight bridge.

Models declare their parameters as a nested dict of :class:`ParamDef`
(shape + logical axes + init rule), exactly as the JAX package does, so
the two packages describe one model with one tree.  From it:

  * ``init_params(defs, generator, device)`` — real tensors in the
    reference's layout (stacked blocks, ``(in, out)`` projections), drawn
    with the reference's rules;
  * ``params_from_numpy(cfg, tree, device)`` — the JAX package's
    parameter tree, as numpy arrays, turned into the port's module state
    (the weight bridge the parity tests and checkpoints cross);
  * ``param_count`` / ``param_bytes``.

The mesh views (``shape_structs``, ``pspec_tree``) stay in the JAX
package: the port runs on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    dtype: str = "bfloat16"
    init: str = "normal"                     # normal | zeros | ones | fan_in
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(fn: Callable[[str, ParamDef], Any], defs: Any) -> Any:
    """Map over a nested dict of ParamDefs with '/'-joined path names."""

    def rec(node, path):
        if _is_def(node):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: rec(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        raise TypeError(f"unexpected node at {path}: {type(node)}")

    return rec(defs, "")


def init_params(defs: Any, generator: torch.Generator,
                device="cuda") -> Any:
    """Random parameters in the reference's layout, on ``device``.

    The rules are the reference's (``repro/models/param.py``): zeros,
    ones, normal with std ``scale`` (0.02 by default), and ``fan_in``
    with std ``scale / sqrt(shape[0])``.  ``fan_in`` reads the FIRST dim,
    which for stacked block weights is the layer count, not the input
    width; the port keeps that, so its random model has the reference's
    statistics.  Draws come from ``generator`` (which must live on
    ``device``) in f32 and are cast to each def's dtype; torch and JAX
    give different numbers from one seed, so tests that compare the two
    bridge the reference's own tree instead."""
    dev = resolve_device(device)

    def make(_, d: ParamDef) -> torch.Tensor:
        dtype = torch_dtype(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "fan_in":
            fan_in = d.shape[0] if d.shape else 1
            scale = d.scale if d.scale is not None else 1.0
            std = scale / math.sqrt(max(1, fan_in))
        else:
            std = d.scale if d.scale is not None else 0.02
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dtype)

    return tree_map_defs(make, defs)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array (as ``np.asarray`` gives a JAX array) as a tensor
    of the same dtype on ``device``.  ``torch.from_numpy`` rejects the
    ``ml_dtypes.bfloat16`` arrays JAX hands out, so a bf16 array crosses
    as f32, which holds every bf16 value exactly, and is cast back."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)      # a writable copy


def params_from_numpy(cfg, tree: Any, device="cuda"):
    """The weight bridge: the JAX package's parameter tree for ``cfg``
    (``jax.tree.map(np.asarray, params)``) -> the port's module state on
    ``device``.  Block weights are unstacked along their leading layer
    dim and each projection is transposed to ``nn.Linear``'s
    ``(out, in)``; values and dtypes are kept exactly."""
    from repro_torch.models.model import build_model   # model imports us
    dev = resolve_device(device)
    tensors = _map_leaves(lambda a: _tensor_from_numpy(a, dev), tree)
    return build_model(cfg).params_from_tree(tensors)


def _map_leaves(fn, node):
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    return fn(node)


def param_bytes(defs: Any) -> int:
    total = [0]

    def add(_, d: ParamDef):
        n = 1
        for s in d.shape:
            n *= s
        total[0] += n * torch_dtype(d.dtype).itemsize

    tree_map_defs(add, defs)
    return total[0]


def param_count(defs: Any) -> int:
    total = [0]

    def add(_, d: ParamDef):
        n = 1
        for s in d.shape:
            n *= s
        total[0] += n

    tree_map_defs(add, defs)
    return total[0]
