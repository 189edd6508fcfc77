"""Conformal UQ: the counterpart of ``rag_uq_tpu/uq/conformal.py``.

Ported so far: the length-ratio nonconformity heuristic that the HTTP
front end's ``/answer`` turns into its confidence. The calibration, the
device quantile and the MC modes wait for a later slice (``ROADMAP.md``).
"""

from __future__ import annotations


class ConformalRAG:
    """The conformal predictor; only its static heuristic is ported."""

    @staticmethod
    def estimate_nonconformity(prediction: str, context: str) -> float:
        """Length-ratio heuristic 1 - min(1, 4r(1-r)), r = |prediction| /
        (|context| + 1) in whitespace tokens."""
        pred_tokens = len(prediction.split())
        context_tokens = len(context.split())
        r = pred_tokens / (context_tokens + 1)
        return 1.0 - min(1.0, 4 * r * (1 - r))
