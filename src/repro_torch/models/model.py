"""Unified model API, as in the JAX package:

  model = build_model(cfg)
  defs   = model.param_defs()                       # ParamDef tree
  params = model.init_params(generator, device)     # module state
  last_logits, cache = model.prefill(params, batch, window=...)
  logits, cache = model.decode_step(params, cache, tokens)
  cache = model.init_cache(batch_size, max_seq, device=...)

This slice serves the ``dense`` family.  ``build_model`` raises
``NotImplementedError`` for the others, naming the ROADMAP item that
ports each.  The training objective (``loss``) arrives with the training
slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.param import init_params

_NOT_PORTED = {
    "moe": "ROADMAP A10 (models/moe.py and the moe_gmm kernel, B5)",
    "ssm": "ROADMAP A9 (models/ssd.py and the ssd_scan kernel, B4)",
    "hybrid": "ROADMAP A9 (models/ssd.py and the ssd_scan kernel, B4)",
    "vlm": "ROADMAP A11 (the patch frontend)",
    "audio": "ROADMAP A11 (the frame frontend)",
}


class BaseModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- parameters -------------------------------------------------------
    def param_defs(self) -> Dict[str, Any]:
        raise NotImplementedError

    def params_from_tree(self, tree: Dict[str, Any]):
        """Module state from a tree of tensors in the reference's layout."""
        raise NotImplementedError

    def init_params(self, generator: torch.Generator, device="cuda"):
        """Random module state drawn with the reference's init rules."""
        return self.params_from_tree(
            init_params(self.param_defs(), generator, device))

    # ---- overridden per family -------------------------------------------
    def forward(self, params, batch, *, collect_cache=False, window=0):
        raise NotImplementedError

    def prefill(self, params, batch, *, window: int = 0):
        raise NotImplementedError

    def decode_step(self, params, cache, tokens):
        raise NotImplementedError

    def init_cache(self, batch_size: int, max_seq: int, *, device="cuda"):
        raise NotImplementedError


class TransformerModel(BaseModel):
    def param_defs(self):
        return T.transformer_defs(self.cfg)

    def params_from_tree(self, tree):
        return T.TransformerParams(self.cfg, tree)

    def forward(self, params, batch, *, collect_cache=False, window=0):
        return T.forward(self.cfg, params, batch,
                         collect_cache=collect_cache, window=window)

    def prefill(self, params, batch, *, window: int = 0):
        return T.prefill(self.cfg, params, batch, window=window)

    def decode_step(self, params, cache, tokens):
        return T.decode_step(self.cfg, params, cache, tokens)

    def init_cache(self, batch_size: int, max_seq: int, *, device="cuda"):
        return T.init_cache(self.cfg, batch_size, max_seq, device=device)


def build_model(cfg: ModelConfig) -> BaseModel:
    if cfg.family == "dense":
        return TransformerModel(cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
