"""Inputs from the seed: the synthetic corpus and the query streams.

The corpus and query recipe is ``chip_smoke.py::zipf_passages`` and
``query_batch`` (bench.py's recipe) reshaped to a configuration's laws:
Zipf term ids, log-normal passage lengths clipped to the configured range,
and queries cut from a source passage at a log-normal length. Every
random draw comes from one ``numpy.random.Generator`` per stream, seeded
by the run's seed and the stream's name, so the same seed gives the same
inputs whatever else the run does.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), zlib.crc32(stream.encode())])


def lognormal_lengths(r: np.random.Generator, n: int, law: Dict) -> np.ndarray:
    """Lengths with mean ``law['mean']`` before clipping to [min, max]."""
    sigma = law["sigma"]
    mu = np.log(law["mean"]) - sigma * sigma / 2.0
    raw = np.rint(r.lognormal(mu, sigma, size=n))
    return np.clip(raw, law["min"], law["max"]).astype(np.int64)


def zipf_corpus(seed: int, corpus: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(terms [n, max_len] int64, 0 past each length; lengths [n]).

    The lengths are one fixed draw for every seed, in the seed's order, so
    every seed's corpus holds the same amount of text."""
    r = rng(seed, "corpus")
    n, vocab = corpus["passages"], corpus["vocab"]
    lengths = r.permutation(lognormal_lengths(rng(0, "corpus"), n, corpus["length"]))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -corpus["zipf_s"]
    cdf = np.cumsum(p / p.sum())
    flat = np.searchsorted(cdf, r.random(int(lengths.sum())), side="right")
    flat = np.minimum(flat, vocab - 1)
    terms = np.zeros((n, int(lengths.max())), dtype=np.int64)
    mask = np.arange(terms.shape[1])[None, :] < lengths[:, None]
    terms[mask] = flat
    return terms, lengths


def passage_texts(terms: np.ndarray, lengths: np.ndarray) -> List[str]:
    words = [str(t) for t in range(int(terms.max()) + 1)]
    return [" ".join([words[t] for t in row[:n]]) for row, n in zip(terms.tolist(), lengths)]


def span_queries(seed: int, stream: str, terms: np.ndarray, lengths: np.ndarray,
                 n: int, law: Dict) -> Tuple[np.ndarray, List[str]]:
    """(source passages [n], queries): each query a contiguous span of its
    source passage, of a log-normal length cut to the passage. The lengths
    are one fixed draw for every seed, in the seed's order."""
    r = rng(seed, stream)
    src = r.integers(0, terms.shape[0], size=n)
    qlen = np.minimum(r.permutation(lognormal_lengths(rng(0, stream), n, law)), lengths[src])
    start = (r.random(n) * (lengths[src] - qlen + 1)).astype(np.int64)
    out = []
    for s, a, m in zip(src, start, qlen):
        out.append(" ".join(str(t) for t in terms[s, a : a + m]))
    return src, out
