"""Combined MC + conformal uncertainty: the counterpart of ``rag_uq_tpu/uq/hybrid.py``.

Combined confidence = the mean of the two signals; the answer is the
conformal prediction when it is reliable, else the MC consensus.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.embed.base import Embedder
from rag_uq_tpu_torch.uq.conformal import ConformalRAG
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence


class HybridConfidence:
    def __init__(
        self,
        llm_client,
        mc_samples: int = 5,
        conformal_alpha: float = 0.1,
        calibration_db_path: str = "data/calibration_scores.db",
        embedder: Optional[Embedder] = None,
        device: DeviceLike = "cuda",
    ):
        self.mc = MCDropoutConfidence(
            llm_client, n_samples=mc_samples, embedder=embedder, device=device)
        self.conformal = ConformalRAG(
            llm_client,
            calibration_db_path=calibration_db_path,
            alpha=conformal_alpha,
            device=device,
        )

    def estimate_uncertainty(
        self,
        prompt: str,
        context: str,
        question: str,
        model: Optional[str] = None,
    ) -> Dict[str, Any]:
        mc_result = self.mc.get_confidence_interval(prompt, context, question)
        conformal_result = self.conformal.predict_with_coverage(question, context)

        combined = (mc_result.confidence + conformal_result.confidence) / 2
        if conformal_result.is_reliable:
            final_answer = conformal_result.prediction
            answer_source = "conformal"
        else:
            final_answer = mc_result.consensus_answer
            answer_source = "mc_consensus"

        return {
            "answer": final_answer,
            "answer_source": answer_source,
            "combined_confidence": combined,
            "mc_confidence": mc_result.confidence,
            "mc_uncertainty": mc_result.uncertainty_score,
            "mc_embedding_variance": mc_result.embedding_variance,
            "conformal_confidence": conformal_result.confidence,
            "conformal_p_value": conformal_result.p_value,
            "is_reliable": conformal_result.is_reliable,
            "mc_answers": mc_result.answers,
            "metadata": {
                "mc": mc_result.metadata,
                "conformal": conformal_result.metadata,
            },
        }
