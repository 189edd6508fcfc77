"""Split conformal prediction with SQLite-persisted calibration: the
counterpart of ``rag_uq_tpu/uq/conformal.py``.

Calibration scores live in the SQLite table ``calibration_scores`` (the JAX
package's schema, so either package reads the other's file), keyed by the
md5 of ``question|||context`` for resumable calibration. The threshold is
the quantile of the scores at ``min(ceil((n+1)(1-alpha))/n, 1)`` with linear
interpolation, and the p-value is ``(#{s >= e} + 1)/(n + 1)``; both are torch
functions on the scores' device (``conformal_threshold_device`` and
``conformal_p_value_device``), in float32 as the JAX ones are.

Two nonconformity modes, as in the JAX package:

- ``"length_ratio"``: calibration scores are 1 - ROUGE-L against the truth;
  inference estimates nonconformity with the answer/context length ratio
  1 - min(1, 4r(1-r)) (a heuristic guarantee);
- ``"mc_variance"``: the MC sampling uncertainty (``uq/mc.py``) at both
  calibration and inference, seeded from the example's query hash, so the
  scores are exchangeable.
"""

from __future__ import annotations

import hashlib
import logging
import sqlite3
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.eval.metrics import rouge_l as _rouge_l

logger = logging.getLogger(__name__)


@dataclass
class ConformalResult:
    """Result of a conformal prediction."""

    prediction: str
    confidence: float
    p_value: float
    is_reliable: bool
    coverage_alpha: float
    metadata: Dict[str, Any] = field(default_factory=dict)


def conformal_threshold_device(scores: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 - alpha) quantile with the finite-sample correction, linear
    interpolation (``jnp.quantile``'s default), float32 on ``scores``' device."""
    n = scores.shape[0]
    one_minus = 1.0 - torch.tensor(alpha, dtype=torch.float32, device=scores.device)
    q_level = torch.clamp(torch.ceil((n + 1) * one_minus) / n, max=1.0)
    return torch.quantile(scores.float(), q_level, interpolation="linear")


def conformal_p_value_device(scores: torch.Tensor, estimated: float) -> torch.Tensor:
    """p = (#{s >= estimated} + 1) / (n + 1), float32 on ``scores``' device."""
    n = scores.shape[0]
    est = torch.tensor(estimated, dtype=torch.float32, device=scores.device)
    rank = (scores >= est).sum().float()
    return (rank + 1.0) / (n + 1.0)


class ConformalRAG:
    """Conformal predictor with coverage P >= 1 - alpha."""

    _MC_INSTRUCTION = (
        "Answer the following question based on the provided context.\n"
        "Be concise and precise."
    )

    def __init__(
        self,
        llm_client,
        calibration_db_path: str = "data/calibration_scores.db",
        alpha: float = 0.1,
        nonconformity_mode: str = "length_ratio",
        mc=None,
        n_mc_samples: int = 8,
        device: DeviceLike = "cuda",
    ):
        if nonconformity_mode not in ("length_ratio", "mc_variance"):
            raise ValueError(f"unknown nonconformity_mode {nonconformity_mode!r}")
        self.llm = llm_client
        self.alpha = alpha
        self.nonconformity_mode = nonconformity_mode
        self.device = resolve_device(device)
        self._mc = mc
        self._n_mc_samples = n_mc_samples
        self.db_path = Path(calibration_db_path)
        self.calibration_scores: List[float] = []
        self._scores_device: Optional[torch.Tensor] = None
        self._init_database()
        self._load_calibration()

    def _mc_score(self, question: str, context: str):
        """(uncertainty score, consensus answer) from MC sampling, seeded
        from the query hash unless the caller supplied an estimator."""
        if self._mc is not None:
            res = self._mc.get_confidence_interval(self._MC_INSTRUCTION, context, question)
        else:
            from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence

            seed = int(self._compute_query_hash(question, context)[:8], 16)
            res = MCDropoutConfidence(
                self.llm, n_samples=self._n_mc_samples, seed=seed, device=self.device
            ).get_confidence_interval(self._MC_INSTRUCTION, context, question)
        return float(res.uncertainty_score), res.consensus_answer

    # -- storage -----------------------------------------------------------------

    def _init_database(self) -> None:
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        with sqlite3.connect(self.db_path) as conn:
            conn.execute(
                """
                CREATE TABLE IF NOT EXISTS calibration_scores (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    query_hash TEXT UNIQUE,
                    question TEXT,
                    predicted_answer TEXT,
                    true_answer TEXT,
                    nonconformity_score REAL,
                    rouge_l REAL,
                    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP
                )
                """
            )
            conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_query_hash"
                " ON calibration_scores(query_hash)"
            )

    def _load_calibration(self) -> None:
        with sqlite3.connect(self.db_path) as conn:
            cursor = conn.execute(
                "SELECT nonconformity_score FROM calibration_scores ORDER BY id"
            )
            self.calibration_scores = [row[0] for row in cursor.fetchall()]
        self._scores_device = (
            torch.tensor(np.asarray(self.calibration_scores, dtype=np.float32),
                         device=self.device)
            if self.calibration_scores
            else None
        )
        logger.info("Loaded %d calibration scores", len(self.calibration_scores))

    @staticmethod
    def _compute_query_hash(question: str, context: str) -> str:
        return hashlib.md5(f"{question}|||{context}".encode()).hexdigest()

    # -- scoring -----------------------------------------------------------------

    def rouge_l(self, prediction: str, reference: str) -> float:
        return _rouge_l(prediction, reference)

    @staticmethod
    def _build_prompt(context: str, question: str) -> str:
        return (
            "Answer the following question based on the provided context.\n"
            "Be concise and precise.\n\n"
            f"Context: {context}\n\nQuestion: {question}\n\nAnswer:"
        )

    def _generate(self, context: str, question: str) -> str:
        """Generation at T = 0.1; an error gives an empty answer."""
        prompt = self._build_prompt(context, question)
        try:
            return self.llm.generate(prompt, temperature=0.1, top_p=0.9, max_tokens=100).strip()
        except Exception as e:  # the JAX estimator's graceful degradation
            logger.error("Generation failed: %s", e)
            return ""

    def calibrate(
        self,
        questions: Sequence[str],
        contexts: Sequence[str],
        true_answers: Sequence[str],
        model: Optional[str] = None,
        skip_existing: bool = True,
    ) -> Dict[str, Any]:
        """Build the calibration set; rows whose query hash is stored are
        skipped, so an interrupted calibration resumes."""
        pending = []
        skipped = 0
        with sqlite3.connect(self.db_path) as conn:
            for q, ctx, true in zip(questions, contexts, true_answers):
                query_hash = self._compute_query_hash(q, ctx)
                if skip_existing:
                    row = conn.execute(
                        "SELECT 1 FROM calibration_scores WHERE query_hash = ?",
                        (query_hash,),
                    ).fetchone()
                    if row:
                        skipped += 1
                        continue
                pending.append((query_hash, q, ctx, true))

        new_scores: List[float] = []
        batch_size = 32
        for start in range(0, len(pending), batch_size):
            chunk = pending[start : start + batch_size]
            if self.nonconformity_mode == "mc_variance":
                if self._mc is not None and hasattr(self._mc, "get_confidence_batch"):
                    results = self._mc.get_confidence_batch(
                        self._MC_INSTRUCTION,
                        [ctx for _, _, ctx, _ in chunk],
                        [q for _, q, _, _ in chunk],
                    )
                    uncertainties = [float(r.uncertainty_score) for r in results]
                    preds = [r.consensus_answer for r in results]
                else:
                    scored = [self._mc_score(q, ctx) for _, q, ctx, _ in chunk]
                    uncertainties = [u for u, _ in scored]
                    preds = [p for _, p in scored]
            else:
                uncertainties = None
                prompts = [self._build_prompt(ctx, q) for _, q, ctx, _ in chunk]
                if hasattr(self.llm, "generate_batch"):
                    try:
                        preds = self.llm.generate_batch(
                            prompts, [0.1] * len(prompts), [0.9] * len(prompts),
                            max_tokens=100,
                        )
                    except Exception as e:
                        logger.error("Batched generation failed: %s", e)
                        preds = [""] * len(prompts)
                else:
                    preds = [self._generate(ctx, q) for _, q, ctx, _ in chunk]
            preds = [p.strip() for p in preds]

            with sqlite3.connect(self.db_path) as conn:
                for i, ((query_hash, q, ctx, true), pred) in enumerate(zip(chunk, preds)):
                    rouge = self.rouge_l(pred, true)
                    nonconformity = uncertainties[i] if uncertainties is not None else 1.0 - rouge
                    conn.execute(
                        """
                        INSERT OR REPLACE INTO calibration_scores
                        (query_hash, question, predicted_answer, true_answer,
                         nonconformity_score, rouge_l)
                        VALUES (?, ?, ?, ?, ?, ?)
                        """,
                        (query_hash, q, pred, true, nonconformity, rouge),
                    )
                    new_scores.append(nonconformity)

        self._load_calibration()
        scores = np.asarray(self.calibration_scores)
        return {
            "total_calibrated": len(self.calibration_scores),
            "new_calibrated": len(new_scores),
            "skipped": skipped,
            "mean_nonconformity": float(scores.mean()) if scores.size else 0,
            "std_nonconformity": float(scores.std()) if scores.size else 0,
        }

    # -- inference ---------------------------------------------------------------

    def get_conformal_threshold(self) -> float:
        if self._scores_device is None:
            logger.warning("No calibration scores available")
            return 1.0
        return float(conformal_threshold_device(self._scores_device, self.alpha))

    @staticmethod
    def estimate_nonconformity(prediction: str, context: str) -> float:
        """Length-ratio heuristic 1 - min(1, 4r(1-r)), r = |prediction| /
        (|context| + 1) in whitespace tokens."""
        pred_tokens = len(prediction.split())
        context_tokens = len(context.split())
        r = pred_tokens / (context_tokens + 1)
        return 1.0 - min(1.0, 4 * r * (1 - r))

    def predict_with_coverage(
        self, question: str, context: str, model: Optional[str] = None
    ) -> ConformalResult:
        """A prediction and its conformal reliability."""
        if self.nonconformity_mode == "mc_variance":
            estimated, pred = self._mc_score(question, context)
        else:
            pred = self._generate(context, question)
            estimated = None

        if self._scores_device is None:
            return ConformalResult(
                prediction=pred,
                confidence=0.5,
                p_value=0.5,
                is_reliable=False,
                coverage_alpha=self.alpha,
                metadata={"warning": "No calibration data available"},
            )

        threshold = self.get_conformal_threshold()
        if estimated is None:
            estimated = self.estimate_nonconformity(pred, context)
        p_value = float(conformal_p_value_device(self._scores_device, estimated))
        return ConformalResult(
            prediction=pred,
            confidence=1.0 - estimated,
            p_value=p_value,
            is_reliable=p_value > self.alpha,
            coverage_alpha=self.alpha,
            metadata={
                "threshold": threshold,
                "estimated_nonconformity": estimated,
                "calibration_size": len(self.calibration_scores),
            },
        )

    def get_calibration_stats(self) -> Dict[str, Any]:
        if not self.calibration_scores:
            return {"empty": True}
        scores = np.asarray(self.calibration_scores)
        return {
            "count": len(scores),
            "mean": float(scores.mean()),
            "std": float(scores.std()),
            "min": float(scores.min()),
            "max": float(scores.max()),
            "median": float(np.median(scores)),
            "q25": float(np.percentile(scores, 25)),
            "q75": float(np.percentile(scores, 75)),
            "threshold": self.get_conformal_threshold(),
            "alpha": self.alpha,
        }
