"""Deterministic hash tokenizer — offline stand-in for a trained BPE.
Stable across runs/processes (blake2-based), so data-pipeline checkpoints
reproduce the exact token stream."""
from __future__ import annotations

import hashlib
from typing import List

_SPECIALS = {"<pad>": 0, "<bos>": 1, "<eos>": 2}


class HashTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size > len(_SPECIALS) + 1
        self.vocab_size = vocab_size
        self.pad_id, self.bos_id, self.eos_id = 0, 1, 2

    def _tok(self, word: str) -> int:
        h = hashlib.blake2b(word.lower().encode("utf-8", "ignore"),
                            digest_size=4).digest()
        return len(_SPECIALS) + int.from_bytes(h, "little") % (
            self.vocab_size - len(_SPECIALS))

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = True) -> List[int]:
        ids = [self._tok(w) for w in text.split()]
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids) -> str:
        return " ".join(f"<{i}>" for i in ids)
