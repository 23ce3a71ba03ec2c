"""repro_torch.data — the deterministic ``HashTokenizer`` (tokenizer.py)
the serving slice encodes prompts with."""
from repro_torch.data.tokenizer import HashTokenizer

__all__ = ["HashTokenizer"]
