"""Tokenization and feature hashing, as the deployments define them.

- Tokens: lowercase, split on whitespace, strip every ASCII character that
  is not a letter or digit from both ends of a token, drop empty tokens.
- FNV-1a 64 over a token's UTF-8 bytes.
- The hash embedder's features: each token's hash modulo the buckets, then
  each adjacent pair's hash (the two tokens joined by 0x1F), cut to
  ``max_len`` features.

``bulk_term_features`` computes the hash embedder's features for passages
whose words are decimal term ids in bulk with numpy: a pair's hash continues
the FNV state of its first word.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1
_STRIP = "".join(chr(c) for c in range(128) if not chr(c).isalnum())


def tokenize(text: str) -> List[str]:
    out = []
    for tok in text.lower().split():
        tok = tok.strip(_STRIP)
        if tok:
            out.append(tok)
    return out


def fnv1a(data: bytes, h: int = FNV_OFFSET) -> int:
    for byte in data:
        h = ((h ^ byte) * FNV_PRIME) & MASK64
    return h


def ngram_features(text: str, buckets: int, max_len: int) -> List[int]:
    toks = tokenize(text)
    feats = [fnv1a(t.encode()) % buckets for t in toks]
    feats += [fnv1a((a + "\x1f" + b).encode()) % buckets for a, b in zip(toks, toks[1:])]
    return feats[:max_len]


def padded(rows: Sequence[Sequence[int]], width: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(rows), width), dtype=np.int64)
    lengths = np.zeros(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        lengths[i] = len(r)
    return ids, lengths


def bulk_term_features(terms: np.ndarray, lengths: np.ndarray, vocab: int,
                       buckets: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hash-embedder features of passages of decimal term ids.

    ``terms`` [n, Lmax] holds each passage's term ids (valid up to
    ``lengths``). Returns (ids [n, max_len] int64, counts [n])."""
    words = [str(t).encode() for t in range(vocab)]
    uni = np.array([fnv1a(w) for w in words], dtype=np.uint64)
    width = max(len(w) for w in words)
    digits = np.zeros((vocab, width), dtype=np.uint64)
    wlen = np.array([len(w) for w in words])
    for j in range(width):
        digits[:, j] = [w[j] if j < len(w) else 0 for w in words]
    n = terms.shape[0]
    n_uni = np.minimum(lengths, max_len)
    n_bi = np.clip(np.minimum(lengths - 1, max_len - n_uni), 0, None)
    out = np.zeros((n, max_len), dtype=np.int64)
    cols = np.arange(max_len)
    t_uni = terms[:, :max_len]
    uni_feat = (uni[t_uni] % np.uint64(buckets)).astype(np.int64)
    out[:, : t_uni.shape[1]] = np.where(cols[None, : t_uni.shape[1]] < n_uni[:, None], uni_feat, 0)
    span = int(n_bi.max()) if n else 0
    if span:
        a, b = terms[:, :span], terms[:, 1 : span + 1]
        prime = np.uint64(FNV_PRIME)
        with np.errstate(over="ignore"):
            h = (uni[a] ^ np.uint64(0x1F)) * prime
            for j in range(width):
                step = (h ^ digits[b, j]) * prime
                h = np.where(j < wlen[b], step, h)
        bi_feat = (h % np.uint64(buckets)).astype(np.int64)
        k = np.arange(span)[None, :]
        rows, ks = np.nonzero(k < n_bi[:, None])
        out[rows, n_uni[rows] + ks] = bi_feat[rows, ks]
    return out, n_uni + n_bi
