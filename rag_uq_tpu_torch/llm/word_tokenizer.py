"""A stand-in word tokenizer for generators whose published tokenizer is not
in the repository (``llm/deepseek_v2.py``).

One token a whitespace-separated word: a decimal word ``t < n_words``
(digits only) is id ``t``, any other word a seeded 32-bit FNV-1a hash of
its UTF-8 bytes modulo ``n_words``. BOS is ``n_words`` and EOS
``n_words + 1``. Decoding writes each id as its decimal string, stops at
EOS and skips BOS, so a text of canonical decimal words below ``n_words``
round-trips. It makes about one token a word, about 25% fewer than a BPE
tokenizer makes of English text.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List, Sequence

DECIMAL = re.compile(r"[0-9]+")


def fnv1a(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class WordTokenizer:
    def __init__(self, n_words: int = 100_000, seed: int = 0):
        self.n_words = int(n_words)
        self.bos = self.n_words
        self.eos = self.n_words + 1
        salt = int(seed).to_bytes(8, "little", signed=True)
        n = self.n_words

        @lru_cache(maxsize=1 << 16)
        def hashed(word: str) -> int:
            return fnv1a(salt + word.encode("utf-8")) % n

        self._hashed = hashed

    def word_id(self, word: str) -> int:
        if DECIMAL.fullmatch(word) and len(word) <= 9 and int(word) < self.n_words:
            return int(word)
        return self._hashed(word)

    def encode(self, text: str) -> List[int]:
        """BOS, then one id a word."""
        return [self.bos] + [self.word_id(w) for w in text.split()]

    def decode(self, ids: Sequence[int]) -> str:
        words = []
        for t in ids:
            t = int(t)
            if t == self.eos:
                break
            if t != self.bos:
                words.append(str(t))
        return " ".join(words)
