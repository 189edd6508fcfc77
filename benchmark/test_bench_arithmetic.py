"""The yardstick's arithmetic on hand-worked shapes: rooflines, spreads and
the corpus laws."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import generate, stats
from benchmark.metrics import _roofline as rl

PEAKS = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}


def test_bm25_pool_bytes_count_distinct_terms_once():
    df = {1: 10, 2: 5, 7: 100}
    # terms 1, 2, 7 (2 repeated, 9 unknown): 115 postings at 8 bytes, 5 ids
    # at 4, and 2 queries x pool 3 outputs at 8.
    assert rl.bm25_pool_bytes(df, [1, 2, 2, 7, 9], 5, 2, 3) == 8 * 115 + 4 * 5 + 8 * 6


def test_dense_pool_least_time_takes_the_larger_bound():
    ops = rl.dense_pool_ops(2048, 57638, 768)
    assert ops == 2 * 2048 * 57638 * 768
    nbytes = rl.dense_pool_bytes(2048, 57638, 768, 50)
    assert nbytes == 2 * 57638 * 768 + 2 * 2048 * 768 + 8 * 2048 * 50
    assert rl.least_s(ops, nbytes, PEAKS) == pytest.approx(ops / 1e12)
    assert rl.least_s(1.0, 1e9, PEAKS) == pytest.approx(1.0)


def test_tail_counts():
    assert rl.tail_ops(4, 100, 577) == 2 * 4 * 100 * 577
    assert rl.tail_bytes(4, 50, 10) == 8 * 4 * 100 + 8 * 4 * 10


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    # statistics.quantiles' exclusive method: q1 = 10.75, q3 = 14.25.
    assert stats.spread(values) == pytest.approx(3.5 / 12.5)


def test_corpus_laws_and_fixed_sizes():
    corpus = {"passages": 3000, "vocab": 1000, "zipf_s": 1.0,
              "length": {"mean": 132.3, "sigma": 0.7, "min": 20, "max": 1000}}
    terms, lengths = generate.zipf_corpus(7, corpus)
    _, lengths2 = generate.zipf_corpus(8, corpus)
    assert sorted(lengths) == sorted(lengths2)
    assert lengths.min() >= 20 and lengths.max() <= 1000
    assert math.isclose(lengths.mean(), 132.3, rel_tol=0.05)
    counts = np.bincount(terms[np.arange(terms.shape[1])[None] < lengths[:, None]],
                         minlength=1000)
    assert counts[0] > 5 * counts[9] > 0  # Zipf: rank 1 over rank 10 is 10 to 1
    src, queries = generate.span_queries(7, "q", terms, lengths, 500,
                                         {"mean": 10.8, "sigma": 0.4, "min": 3, "max": 24})
    lens = [len(q.split()) for q in queries]
    assert min(lens) >= 3 and max(lens) <= 24 and math.isclose(np.mean(lens), 10.8, rel_tol=0.08)
    words = set(map(str, terms[src[0], : lengths[src[0]]]))
    assert set(queries[0].split()) <= words
