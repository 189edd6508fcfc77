"""RAGEvaluator facade: a copy of ``rag_uq_tpu/eval/evaluator.py``.

Same public surface and report schema as the reference's RAGEvaluator
(rag_uq/eval_protocol.py:126-783) so results are directly comparable.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from rag_uq_tpu_torch.eval import metrics as M
from rag_uq_tpu_torch.eval import plots as plots_mod
from rag_uq_tpu_torch.eval.metrics import (
    CalibrationMetrics,
    EfficiencyMetrics,
    GenerationMetrics,
    RetrievalMetrics,
)

logger = logging.getLogger(__name__)


class RAGEvaluator:
    """Comprehensive evaluation suite (reference: eval_protocol.py:126-166)."""

    def __init__(
        self,
        output_dir: str = "results",
        n_bins: int = 10,
        bootstrap_samples: int = 1000,
    ):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.n_bins = n_bins
        self.bootstrap_samples = bootstrap_samples

    # -- metric groups ------------------------------------------------------

    def evaluate_retrieval(
        self,
        retrieved_ids: Sequence[Sequence[str]],
        gold_ids: Sequence[Sequence[str]],
        relevance_scores: Optional[Sequence[Dict[str, float]]] = None,
        k_values: Sequence[int] = (1, 5, 10, 20),
        router_decisions: Optional[Sequence[int]] = None,
        oracle_decisions: Optional[Sequence[int]] = None,
    ) -> RetrievalMetrics:
        return M.evaluate_retrieval(
            retrieved_ids,
            gold_ids,
            relevance_scores,
            k_values,
            router_decisions,
            oracle_decisions,
        )

    def evaluate_generation(
        self, predictions: Sequence[str], references: Sequence[str]
    ) -> GenerationMetrics:
        return M.evaluate_generation(predictions, references)

    def evaluate_calibration(
        self, confidences: Sequence[float], correctness: Sequence[int]
    ) -> CalibrationMetrics:
        return M.evaluate_calibration(confidences, correctness, self.n_bins)

    def evaluate_efficiency(
        self,
        latencies: Sequence[float],
        router_times: Optional[Sequence[float]] = None,
        retrieval_times: Optional[Sequence[float]] = None,
        generation_times: Optional[Sequence[float]] = None,
    ) -> EfficiencyMetrics:
        return M.evaluate_efficiency(
            latencies, router_times, retrieval_times, generation_times
        )

    # -- plots ---------------------------------------------------------------

    def plot_reliability_diagram(
        self,
        calibration_metrics: CalibrationMetrics,
        title: str = "Reliability Diagram",
        save_path: Optional[str] = None,
    ) -> Optional[str]:
        return plots_mod.plot_reliability_diagram(
            calibration_metrics, title, save_path, str(self.output_dir)
        )

    def plot_routing_analysis(
        self,
        bm25_scores: Sequence[float],
        dense_scores: Sequence[float],
        router_weights: Sequence[float],
        correctness: Optional[Sequence[int]] = None,
        save_path: Optional[str] = None,
    ) -> Optional[str]:
        return plots_mod.plot_routing_analysis(
            bm25_scores,
            dense_scores,
            router_weights,
            correctness,
            save_path,
            str(self.output_dir),
        )

    # -- full evaluation -----------------------------------------------------

    def run_full_evaluation(
        self,
        retrieved_ids: Sequence[Sequence[str]],
        gold_ids: Sequence[Sequence[str]],
        predictions: Sequence[str],
        references: Sequence[str],
        confidences: Sequence[float],
        latencies: Sequence[float],
        router_weights: Optional[Sequence[float]] = None,
        router_decisions: Optional[Sequence[int]] = None,
        oracle_decisions: Optional[Sequence[int]] = None,
        save_results: bool = True,
    ) -> Dict[str, Any]:
        """All metric groups + plots + JSON report (reference :668-746)."""
        retrieval = self.evaluate_retrieval(
            retrieved_ids, gold_ids,
            router_decisions=router_decisions,
            oracle_decisions=oracle_decisions,
        )
        generation = self.evaluate_generation(predictions, references)
        correctness = M.correctness_labels(predictions, references)
        calibration = self.evaluate_calibration(confidences, correctness)
        efficiency = self.evaluate_efficiency(latencies)

        reliability_path = self.plot_reliability_diagram(calibration)
        routing_path = None
        if router_weights:
            routing_path = self.plot_routing_analysis(
                bm25_scores=[0] * len(router_weights),
                dense_scores=[0] * len(router_weights),
                router_weights=router_weights,
                correctness=correctness,
            )

        results = {
            "retrieval": retrieval.to_dict(),
            "generation": generation.to_dict(),
            "calibration": calibration.to_dict(),
            "efficiency": efficiency.to_dict(),
            "plots": {
                "reliability_diagram": reliability_path,
                "routing_analysis": routing_path,
            },
            "summary": {
                "n_queries": len(predictions),
                "mrr": retrieval.mrr,
                "exact_match": generation.exact_match,
                "f1": generation.f1,
                "ece": calibration.ece,
                "avg_latency_ms": efficiency.avg_latency_ms,
            },
        }
        if save_results:
            path = self.output_dir / "evaluation_results.json"
            with open(path, "w") as f:
                json.dump(results, f, indent=2)
            logger.info("Saved evaluation results to %s", path)
        return results

    def bootstrap_metric(
        self,
        data: Sequence[Any],
        metric_fn: Callable[[Sequence[Any]], float],
        n_bootstrap: int = 1000,
        confidence_level: float = 0.95,
    ) -> Tuple[float, float, float]:
        return M.bootstrap_metric(data, metric_fn, n_bootstrap, confidence_level)
