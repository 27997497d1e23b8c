"""Character tokenizer for the synthetic task suite.

Fixed vocabulary: printable task characters + special tokens.  The MASK id
is pinned to ``vocab_size - 1`` to match ``ModelConfig.mask_token_id``'s
default, PAD to 0.
"""
from __future__ import annotations

from typing import List

import numpy as np

_CHARS = "0123456789+-*/=()[]{}<>abcdefghijklmnopqrstuvwxyz ,.:|&^#@!?"


class CharTokenizer:
    PAD = 0

    def __init__(self, vocab_size: int = 128):
        assert vocab_size >= len(_CHARS) + 4
        self.vocab_size = vocab_size
        self._stoi = {c: i + 1 for i, c in enumerate(_CHARS)}
        self._itos = {i + 1: c for i, c in enumerate(_CHARS)}
        self.bos = len(_CHARS) + 1
        self.eos = len(_CHARS) + 2
        self.mask = vocab_size - 1

    def encode(self, s: str) -> List[int]:
        return [self._stoi[c] for c in s]

    def decode(self, ids) -> str:
        out = []
        for i in np.asarray(ids).tolist():
            if i in (self.PAD, self.bos, self.eos, self.mask):
                continue
            out.append(self._itos.get(int(i), "?"))
        return "".join(out)

    def pad_to(self, ids: List[int], length: int) -> List[int]:
        assert len(ids) <= length, (len(ids), length)
        return ids + [self.PAD] * (length - len(ids))
