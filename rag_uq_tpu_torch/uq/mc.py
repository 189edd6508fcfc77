"""MC sampling confidence: the counterpart of ``rag_uq_tpu/uq/mc.py``.

K stochastic generations with temperature drawn uniformly from (0.5, 1.2)
and top-p from (0.8, 0.95) (numpy, seeded), uncertainty = the std of the
answer embeddings' distances from their centroid, normalized as
min(1, variance / 2); consensus = the answer closest to the centroid (the
most common one without embeddings); plus the type-token lexical diversity
and, for a scored generator, the spread of the samples' mean
log-probabilities.

The generator is any ``llm/base.py::Generator``: TinyLM,
``llm/deepseek_v2.py::DeepseekV2LM``, which prefills each example's prompt
once for its K samples and scores them as TinyLM does, or
``llm/kimi_linear.py::KimiLinearLM``, which does the same through its KDA
layers' recurrent states (each prompt's end state copied to its K slots)
and its latent attention.

The default answer embedder is the port's ``NgramHashEmbedder(dim=384)``,
whose seeded table differs from the JAX one (``convert.embedding_table``
carries the JAX table across).

Deviation: ``get_confidence_batch`` sends all B*K prompts through one
``generate_batch`` call with one seed, where the JAX estimator splits them
into calls of at most 64 prompts (a 16 GB TPU's limit; the H100 holds the
KV cache of 160 rows in under 2 GB). The numpy draws therefore match the
JAX estimator's for the same seed when B*K fits one JAX call
(``max(K, 64 - 64 % K)`` prompts).
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.embed.base import Embedder

logger = logging.getLogger(__name__)


@dataclass
class ConfidenceResult:
    """Result of a confidence estimate."""

    answers: List[str]
    consensus_answer: str
    uncertainty_score: float
    confidence: float
    embedding_variance: Optional[float] = None
    lexical_diversity: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


class MCDropoutConfidence:
    """Monte-Carlo sampling confidence for generated answers."""

    def __init__(
        self,
        llm_client,
        n_samples: int = 10,
        embedder: Optional[Embedder] = None,
        temperature_range: Tuple[float, float] = (0.5, 1.2),
        top_p_range: Tuple[float, float] = (0.8, 0.95),
        max_tokens: int = 100,
        seed: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        self.llm = llm_client
        self.n_samples = n_samples
        self.temperature_range = temperature_range
        self.top_p_range = top_p_range
        self.max_tokens = max_tokens
        if embedder is None:
            from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder

            embedder = NgramHashEmbedder(dim=384, device=device)
        self.encoder = embedder
        self._rng = np.random.default_rng(seed)

    def _sample_parameters(self) -> Dict[str, float]:
        return {
            "temperature": float(self._rng.uniform(*self.temperature_range)),
            "top_p": float(self._rng.uniform(*self.top_p_range)),
        }

    @staticmethod
    def build_prompt(prompt: str, context: str, question: str) -> str:
        return f"{prompt}\n\nContext: {context}\n\nQuestion: {question}\n\nAnswer:"

    def _compute_lexical_diversity(self, answers: List[str]) -> float:
        """Type-token ratio across answers."""
        all_tokens: List[str] = []
        for answer in answers:
            all_tokens.extend(answer.lower().split())
        if not all_tokens:
            return 1.0
        return len(set(all_tokens)) / len(all_tokens)

    def _compute_embedding_variance(
        self, answers: List[str]
    ) -> Tuple[float, np.ndarray, np.ndarray]:
        """Std of the answer embeddings' distances from their centroid."""
        valid = [a for a in answers if a.strip()]
        if self.encoder is None or not valid:
            return 1.0, np.array([]), np.array([])
        embeddings = np.asarray(self.encoder.encode(valid))
        centroid = embeddings.mean(axis=0)
        distances = np.linalg.norm(embeddings - centroid, axis=1)
        return float(distances.std()), centroid, embeddings

    def get_confidence_batch(
        self,
        prompt: str,
        contexts: Sequence[str],
        questions: Sequence[str],
    ) -> List[ConfidenceResult]:
        """MC confidence for a whole example batch: all B*K samples in one
        ``generate_batch`` (grouped per example); per-example math as in
        ``get_confidence_interval``."""
        n = len(questions)
        if n == 0:
            return []
        prompts, temps, tops = [], [], []
        for ctx, q in zip(contexts, questions):
            full = self.build_prompt(prompt, ctx, q)
            for _ in range(self.n_samples):
                p = self._sample_parameters()
                prompts.append(full)
                temps.append(p["temperature"])
                tops.append(p["top_p"])
        seed = int(self._rng.integers(0, 2**31 - 1))
        scored = hasattr(self.llm, "generate_batch_scored")
        lps: List[float] = []
        if scored:
            raw, mean_lp, _ = self.llm.generate_batch_scored(
                prompts, temps, tops, max_tokens=self.max_tokens, seed=seed)
            lps = [float(x) for x in mean_lp]
        else:
            raw = self.llm.generate_batch(
                prompts, temps, tops, max_tokens=self.max_tokens, seed=seed)
        results = []
        for i in range(n):
            group = raw[i * self.n_samples : (i + 1) * self.n_samples]
            keep = [j for j, a in enumerate(group) if a and a.strip()]
            answers = [group[j].strip() for j in keep]
            r = self._result_from_answers(answers)
            if scored:
                # The spread of the kept samples' mean log-probabilities, over
                # the same non-blank subset as the text features.
                ex = np.asarray([lps[i * self.n_samples + j] for j in keep])
                r.metadata["sample_lp_mean"] = float(ex.mean()) if ex.size else -10.0
                r.metadata["sample_lp_spread"] = float(ex.std()) if ex.size else 0.0
            results.append(r)
        return results

    def _result_from_answers(self, answers: List[str]) -> ConfidenceResult:
        if not answers:
            return ConfidenceResult(
                answers=[],
                consensus_answer="",
                uncertainty_score=1.0,
                confidence=0.0,
                metadata={"error": "No valid answers generated"},
            )
        lexical_diversity = self._compute_lexical_diversity(answers)
        variance, centroid, embeddings = self._compute_embedding_variance(answers)
        if len(embeddings) > 0:
            distances = np.linalg.norm(embeddings - centroid, axis=1)
            consensus = answers[int(np.argmin(distances))]
        else:
            consensus = Counter(answers).most_common(1)[0][0]
        normalized_uncertainty = min(1.0, variance / 2.0)
        norm = lambda a: " ".join(a.lower().split())
        n_consensus = norm(consensus)
        agreement_rate = sum(1 for a in answers if norm(a) == n_consensus) / len(answers)
        lens = np.asarray([len(a.split()) for a in answers], dtype=np.float64)
        return ConfidenceResult(
            answers=answers,
            consensus_answer=consensus,
            uncertainty_score=normalized_uncertainty,
            confidence=1.0 - normalized_uncertainty,
            embedding_variance=variance,
            lexical_diversity=lexical_diversity,
            metadata={
                "n_samples": len(answers),
                "temperature_range": self.temperature_range,
                "top_p_range": self.top_p_range,
                "agreement_rate": float(agreement_rate),
                "answer_len_mean": float(lens.mean()),
                "answer_len_spread": float(lens.std()),
            },
        )

    def get_confidence_interval(
        self,
        prompt: str,
        context: str,
        question: str,
        model: Optional[str] = None,  # kept for API compatibility
    ) -> ConfidenceResult:
        """MC confidence estimate for one example: K samples in one batch."""
        full_prompt = self.build_prompt(prompt, context, question)
        params = [self._sample_parameters() for _ in range(self.n_samples)]
        raw = self.llm.generate_batch(
            [full_prompt] * self.n_samples,
            [p["temperature"] for p in params],
            [p["top_p"] for p in params],
            max_tokens=self.max_tokens,
            seed=int(self._rng.integers(0, 2**31 - 1)),
        )
        answers = [a.strip() for a in raw if a and a.strip()]
        return self._result_from_answers(answers)
