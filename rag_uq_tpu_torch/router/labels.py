"""Pseudo-relevance labels from answer overlap.

A copy of ``rag_uq_tpu/router/labels.py`` (numpy only), held to it by
``tests/test_torch_data.py``.

Parity with the reference's create_pseudo_labels (rag_uq/router.py:520-561):
relevance = 1.0 if the lowercased answer appears as a substring of the
passage, else the token-overlap fraction |answer ∩ passage| / |answer|;
labels zero-padded to num_passages.

One deliberate fix: the reference dedups the combined passage list through a
Python set (router.py:545-547), making label order nondeterministic across
runs. We dedup with order preservation (first occurrence wins), so labels
align with the bm25-then-dense passage order deterministically.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def relevance_of(passage: str, answer: str) -> float:
    """Single-passage pseudo-relevance: 1.0 on answer substring, else the
    answer-token overlap fraction (the reference's scoring rule,
    router.py:548-555)."""
    answer_lower = answer.lower()
    passage_lower = passage.lower()
    if answer_lower and answer_lower in passage_lower:
        return 1.0
    answer_tokens = set(answer_lower.split())
    if not answer_tokens:
        return 0.0
    return len(answer_tokens & set(passage_lower.split())) / len(answer_tokens)


def aligned_pseudo_labels(texts, answer: str) -> np.ndarray:
    """Position-aligned labels for a retrieved passage list (no dedup):
    labels[i] scores texts[i], so they stay aligned with positionally
    aligned score arrays even when retrieved texts repeat. Empty padding
    slots get 0."""
    return np.asarray(
        [relevance_of(t, answer) if t else 0.0 for t in texts],
        dtype=np.float32,
    )


def create_pseudo_labels(
    bm25_passages: Sequence[str],
    dense_passages: Sequence[str],
    answer: str,
    num_passages: int = 20,
) -> np.ndarray:
    """Relevance labels [num_passages] float32."""
    answer_lower = answer.lower()
    answer_tokens = set(answer_lower.split())

    combined = list(bm25_passages[:num_passages]) + list(dense_passages[:num_passages])
    unique = list(dict.fromkeys(combined))[:num_passages]

    labels: List[float] = []
    for passage in unique:
        passage_lower = passage.lower()
        if answer_lower in passage_lower:
            labels.append(1.0)
        else:
            passage_tokens = set(passage_lower.split())
            overlap = (
                len(answer_tokens & passage_tokens) / len(answer_tokens)
                if answer_tokens
                else 0.0
            )
            labels.append(overlap)

    while len(labels) < num_passages:
        labels.append(0.0)
    return np.asarray(labels[:num_passages], dtype=np.float32)
