"""Conformal calibration experiment CLI: the counterpart of ``rag_uq_tpu/cli/calibrate.py``.

Capability parity with the reference's experiment
(experiments/run_calibration.py): calibrates on the first `n_calibration`
QA samples with contexts truncated to 2000 chars (:32-54,83), dumps
calibration statistics (:57-120), and a --test mode running held-out
conformal predictions with a reliable-ratio report (:123-206). A MockLLM is
used when no generator is configured (:90-95). The calibration scores
live on ``device`` (the conformal quantile and p-values are torch there).

Run: ``python3 -m rag_uq_tpu_torch.cli.calibrate --nq-path nq.jsonl
[--test] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional, Sequence

from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.data.loaders import load_qa_jsonl
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.uq.conformal import ConformalRAG
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence

logger = logging.getLogger(__name__)


def run_calibration(
    nq_path: str,
    llm_client=None,
    n_calibration: int = 500,
    alpha: float = 0.1,
    db_path: str = "data/calibration_scores.db",
    max_context_chars: int = 2000,
    output_path: Optional[str] = "results/calibration_results.json",
    nonconformity_mode: str = "length_ratio",
    device: DeviceLike = "cuda",
) -> dict:
    samples = load_qa_jsonl(nq_path, limit=n_calibration)
    llm = llm_client or MockLLM()
    mc = None
    if nonconformity_mode == "mc_variance":
        # Explicit estimator => calibrate() scores whole chunks through
        # one B*K-sample generate call (uq/mc.get_confidence_batch).
        mc = MCDropoutConfidence(llm, n_samples=8, seed=0, device=device)
    conformal = ConformalRAG(llm, calibration_db_path=db_path, alpha=alpha,
                             nonconformity_mode=nonconformity_mode, mc=mc,
                             device=device)

    questions = [s["question"] for s in samples]
    contexts = [str(s.get("context", ""))[:max_context_chars] for s in samples]
    answers = [
        (s.get("answers") or [s.get("answer", "")])[0] for s in samples
    ]
    stats = conformal.calibrate(questions, contexts, answers)
    stats["calibration_stats"] = conformal.get_calibration_stats()
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(stats, f, indent=2)
    logger.info("Calibration complete: %s", stats)
    return stats


def test_conformal_predictions(
    nq_path: str,
    llm_client=None,
    n_calibration: int = 500,
    n_test: int = 100,
    alpha: float = 0.1,
    db_path: str = "data/calibration_scores.db",
    max_context_chars: int = 2000,
    device: DeviceLike = "cuda",
) -> dict:
    """Held-out conformal predictions + reliable ratio (parity :123-206)."""
    samples = load_qa_jsonl(nq_path, limit=n_calibration + n_test)
    test = samples[n_calibration : n_calibration + n_test]
    llm = llm_client or MockLLM()
    conformal = ConformalRAG(llm, calibration_db_path=db_path, alpha=alpha,
                             device=device)

    reliable = 0
    p_values = []
    for s in test:
        result = conformal.predict_with_coverage(
            s["question"], str(s.get("context", ""))[:max_context_chars]
        )
        reliable += int(result.is_reliable)
        p_values.append(result.p_value)
    report = {
        "n_test": len(test),
        "reliable_count": reliable,
        "reliable_ratio": reliable / max(len(test), 1),
        "mean_p_value": sum(p_values) / max(len(p_values), 1),
        "alpha": alpha,
    }
    logger.info("Conformal test: %s", report)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Conformal calibration")
    parser.add_argument("--nq-path", default="data/preprocessed/nq_dev_3000.jsonl")
    parser.add_argument("--n-calibration", type=int, default=500)
    parser.add_argument("--alpha", type=float, default=0.1)
    parser.add_argument("--db-path", default="data/calibration_scores.db")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--n-test", type=int, default=100)
    parser.add_argument("--output", default="results/calibration_results.json")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    run_calibration(
        args.nq_path,
        n_calibration=args.n_calibration,
        alpha=args.alpha,
        db_path=args.db_path,
        output_path=args.output,
        device=args.device,
    )
    if args.test:
        print(json.dumps(test_conformal_predictions(
            args.nq_path,
            n_calibration=args.n_calibration,
            n_test=args.n_test,
            alpha=args.alpha,
            db_path=args.db_path,
            device=args.device,
        ), indent=2))


if __name__ == "__main__":
    main()
