"""Answer metrics: the counterpart of ``rag_uq_tpu/eval/metrics.py:222-262``.

``normalize_answer``, ``exact_match``, ``token_f1`` and ``rouge_l`` are what
answer selection, the MC estimator and the conformal scores need; the rest
of the JAX module (retrieval metrics, calibration, latency) waits for the
evaluation slice.

Deviation: the JAX ``rouge_l`` scores with ``rouge-score`` (LCS with Porter
stemming) where that package is installed and falls back to ``token_f1``
where it is not. The port imports only torch, numpy and the standard
library, so its ``rouge_l`` is that fallback: the JAX function's value on a
machine without ``rouge-score``, such as the card's.
"""

from __future__ import annotations

import re

_PUNCT_RE = re.compile(r"[^\w\s]")


def normalize_answer(text: str) -> str:
    """Lowercase, strip punctuation, collapse whitespace."""
    text = text.lower()
    text = _PUNCT_RE.sub("", text)
    return " ".join(text.split())


def exact_match(prediction: str, reference: str) -> float:
    return float(normalize_answer(prediction) == normalize_answer(reference))


def token_f1(prediction: str, reference: str) -> float:
    """Set-based token F1 over normalized answers."""
    pred_tokens = set(normalize_answer(prediction).split())
    ref_tokens = set(normalize_answer(reference).split())
    if not pred_tokens or not ref_tokens:
        return 0.0
    common = pred_tokens & ref_tokens
    precision = len(common) / len(pred_tokens)
    recall = len(common) / len(ref_tokens)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def rouge_l(prediction: str, reference: str) -> float:
    """The JAX ``rouge_l`` without ``rouge-score``: token F1."""
    return token_f1(prediction, reference)
