"""repro_torch.models — the dense decoder transformer, forward only:
parameter defs, random init and the weight bridge from the JAX package
(param.py), layers (layers.py), the blocks, prefill and decode
(transformer.py) and the unified model API (model.py)."""
