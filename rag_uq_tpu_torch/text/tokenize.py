"""Tokenization and vocabulary: a copy of ``rag_uq_tpu/text/tokenize.py``.

The reference tokenizes by lowercase + whitespace split for BM25
(rag_uq/streaming_index.py:118-120), which leaves sentence punctuation glued
to tokens: an entity mentioned once, sentence-finally ("...remains
Guschisshous.") can NEVER match the clean query token "guschisshous". The
reference gets away with it only because its dense tower (nomic-embed) has a
real subword tokenizer; our dense tower hashes these same tokens, so both
towers would share the blindness. Deliberate deviation (measured on the
hand-written out-of-family split, where inverse-direction questions scored
recall@10 = 0.0 under whitespace tokenization): tokens additionally have
ASCII punctuation stripped from both EDGES (never the interior — "it's",
"multi-word" survive), and all-punctuation tokens are dropped. The native
C++ tokenizer (native/rag_native.cpp) implements byte-identical semantics.

Also here: a stable 64-bit token hash used by the hashing embedder
(host-side; the device only ever sees integer ids), and ``hash_texts``, the
one hashing path of the encoder and the hashing embedder: in the native
library when it loaded (``native/binding.py::hash_features``), else in
Python, its fallback and twin, with the same ids.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from rag_uq_tpu_torch.native import binding as native
from rag_uq_tpu_torch.utils import profiling

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


# Every ASCII char that is not a letter or digit. Multi-byte UTF-8 sequences
# never contain ASCII bytes, so stripping these from token edges is
# byte-order-safe and exactly mirrors the native tokenizer's per-byte test.
_EDGE_STRIP = "".join(
    chr(c) for c in range(128) if not chr(c).isalnum()
)

# Stamped into persisted index metadata so a saved index built under a
# different tokenization can be detected at load time.
TOKENIZER_VERSION = "v2-edge-punct-strip"


def tokenize(text: str) -> List[str]:
    """Lowercase whitespace tokenization with ASCII edge-punctuation strip.

    Base contract: streaming_index.py:118-120 (lowercase + split); the edge
    strip is a documented deviation (module docstring) fixing the
    reference's sentence-punctuation blindness."""
    out = []
    for tok in text.lower().split():
        tok = tok.strip(_EDGE_STRIP)
        if tok:
            out.append(tok)
    return out


def fnv1a_64(token: str) -> int:
    """Deterministic FNV-1a 64-bit hash (stable across processes/runs)."""
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def hash_tokens(tokens: Iterable[str], buckets: int) -> np.ndarray:
    """Hash tokens into [0, buckets) int32 ids."""
    return np.asarray([fnv1a_64(t) % buckets for t in tokens], dtype=np.int32)


def text_features(text: str, buckets: int, max_len: int, use_bigrams: bool) -> List[int]:
    """One text's hashed features in Python: each token's FNV-1a 64 hash
    modulo ``buckets``, then with ``use_bigrams`` each adjacent pair's
    (``a + "\\x1f" + b``), the list cut to ``max_len``. Only the first
    ``max_len`` tokens can reach the cut list."""
    toks = tokenize(text)[:max_len]
    feats = [fnv1a_64(t) % buckets for t in toks]
    if use_bigrams:
        feats += [fnv1a_64(a + "\x1f" + b) % buckets for a, b in zip(toks, toks[1:])]
    return feats[:max_len]


def hash_texts(
    texts: Iterable[str], buckets: int, max_len: int, use_bigrams: bool = False
) -> "tuple[np.ndarray, np.ndarray]":
    """Batch-hash texts into padded [B, max_len] int32 ids + [B] int32 lengths.

    Unigrams alone are the encoder's features; with bigrams, the hashing
    embedder's (``NgramHashEmbedder._hash_batch``). Long texts are
    truncated, matching typical encoder max-length behavior. The native
    library computes them when it loaded; else ``text_features``, its
    twin, with the same ids.
    """
    texts = list(texts)
    if native.is_available():
        profiling.count("embed.hash_native", len(texts))
        return native.hash_features(texts, buckets, max_len, use_bigrams)
    profiling.count("embed.hash_python", len(texts))
    ids = np.zeros((len(texts), max_len), dtype=np.int32)
    lengths = np.zeros((len(texts),), dtype=np.int32)
    for i, text in enumerate(texts):
        feats = text_features(text, buckets, max_len, use_bigrams)
        lengths[i] = len(feats)
        if feats:
            ids[i, : len(feats)] = np.asarray(feats, dtype=np.int32)
    return ids, lengths


class Vocab:
    """Incremental host-side term vocabulary (term -> dense int id)."""

    def __init__(self) -> None:
        self._term_to_id: Dict[str, int] = {}
        self._terms: List[str] = []

    def __len__(self) -> int:
        return len(self._terms)

    def __contains__(self, term: str) -> bool:
        return term in self._term_to_id

    def add(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._terms)
            self._term_to_id[term] = tid
            self._terms.append(term)
        return tid

    def get(self, term: str) -> Optional[int]:
        return self._term_to_id.get(term)

    def id_of(self, term: str, default: int = -1) -> int:
        return self._term_to_id.get(term, default)

    def term_of(self, tid: int) -> str:
        return self._terms[tid]

    def encode(self, tokens: Iterable[str], default: int = -1) -> np.ndarray:
        return np.asarray(
            [self._term_to_id.get(t, default) for t in tokens], dtype=np.int32
        )
