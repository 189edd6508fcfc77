"""Publication plots: a copy of ``rag_uq_tpu/eval/plots.py``.

Same artifact contract as the reference (rag_uq/eval_protocol.py:509-664):
reliability diagram with perfect-calibration line, count-scaled scatter, ECE
gap shading and ECE/MCE/Brier annotation; routing analysis with weight
histogram, score-diff scatter, and accuracy-by-decision bars. 300 dpi PNGs.

``matplotlib`` is imported at the first plot, not with the module (the
port imports only torch, numpy and the standard library at import). Where
it cannot be imported, each plot logs a warning and returns ``None``, as
the JAX module does.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from rag_uq_tpu_torch.eval.metrics import CalibrationMetrics

logger = logging.getLogger(__name__)


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None (with a warning)
    where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib not available, skipping plot")
        return None
    return plt


def plot_reliability_diagram(
    calibration: CalibrationMetrics,
    title: str = "Reliability Diagram",
    save_path: Optional[str] = None,
    output_dir: str = "results",
) -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot([0, 1], [0, 1], "k--", linewidth=2, label="Perfect calibration")

    counts = calibration.bin_counts
    valid = [i for i, c in enumerate(counts) if c > 0]
    conf = [calibration.confidence_per_bin[i] for i in valid]
    acc = [calibration.accuracy_per_bin[i] for i in valid]
    sizes = [max(50, min(500, counts[i] * 5)) for i in valid]

    ax.scatter(
        conf, acc, s=sizes, alpha=0.7, color="#2E86AB",
        edgecolor="white", linewidth=1.5, label="Model",
    )
    ax.plot(conf, acc, "o-", color="#2E86AB", linewidth=2, markersize=8)
    ax.fill_between(
        conf, conf, acc, alpha=0.2, color="red",
        label=f"Calibration gap (ECE={calibration.ece:.3f})",
    )
    ax.set_xlabel("Confidence", fontsize=14)
    ax.set_ylabel("Accuracy", fontsize=14)
    ax.set_title(title, fontsize=16, fontweight="bold")
    ax.set_xlim([0, 1])
    ax.set_ylim([0, 1])
    ax.legend(loc="lower right", fontsize=12)
    ax.grid(True, alpha=0.3)
    ax.text(
        0.05, 0.95,
        f"ECE: {calibration.ece:.4f}\nMCE: {calibration.mce:.4f}\n"
        f"Brier: {calibration.brier_score:.4f}",
        transform=ax.transAxes, fontsize=11, verticalalignment="top",
        bbox=dict(boxstyle="round", facecolor="white", alpha=0.8),
    )
    plt.tight_layout()

    path = Path(save_path) if save_path else Path(output_dir) / "reliability_diagram.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    logger.info("Saved reliability diagram to %s", path)
    return str(path)


def plot_routing_analysis(
    bm25_scores: Sequence[float],
    dense_scores: Sequence[float],
    router_weights: Sequence[float],
    correctness: Optional[Sequence[int]] = None,
    save_path: Optional[str] = None,
    output_dir: str = "results",
) -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))

    ax1 = axes[0]
    ax1.hist(router_weights, bins=20, edgecolor="white", color="#2E86AB")
    ax1.axvline(x=0.5, color="red", linestyle="--", label="Decision boundary")
    ax1.set_xlabel("Router Weight (0=BM25, 1=Dense)")
    ax1.set_ylabel("Count")
    ax1.set_title("Router Decision Distribution")
    ax1.legend()

    ax2 = axes[1]
    score_diff = np.asarray(dense_scores) - np.asarray(bm25_scores)
    ax2.scatter(score_diff, router_weights, alpha=0.5, color="#2E86AB")
    ax2.set_xlabel("Dense - BM25 Score")
    ax2.set_ylabel("Router Weight")
    ax2.set_title("Score Difference vs Router Decision")
    ax2.axhline(y=0.5, color="red", linestyle="--", alpha=0.5)

    ax3 = axes[2]
    if correctness is not None:
        weights = np.asarray(router_weights)
        correct = np.asarray(correctness)
        dense_mask = weights > 0.5
        bm25_mask = ~dense_mask
        dense_acc = correct[dense_mask].mean() if dense_mask.sum() > 0 else 0
        bm25_acc = correct[bm25_mask].mean() if bm25_mask.sum() > 0 else 0
        ax3.bar(
            ["BM25 Selected", "Dense Selected"],
            [bm25_acc, dense_acc],
            color=["#E8751A", "#2E86AB"],
        )
        ax3.set_ylabel("Accuracy")
        ax3.set_title("Accuracy by Routing Decision")
        ax3.set_ylim([0, 1])
        ax3.text(0, bm25_acc + 0.02, f"n={bm25_mask.sum()}", ha="center")
        ax3.text(1, dense_acc + 0.02, f"n={dense_mask.sum()}", ha="center")
    else:
        ax3.text(
            0.5, 0.5, "Correctness data\nnot available",
            ha="center", va="center", transform=ax3.transAxes,
        )

    plt.tight_layout()
    path = Path(save_path) if save_path else Path(output_dir) / "routing_analysis.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return str(path)


def plot_training_curves(
    train_losses: List[float],
    val_losses: Optional[List[float]] = None,
    save_path: Optional[str] = None,
    output_dir: str = "results",
) -> Optional[str]:
    """Training-curve PNG (reference: experiments/run_router_training.py:217-235)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(train_losses, label="train loss")
    if val_losses:
        ax.plot(val_losses, label="val loss")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss (-ApproxNDCG)")
    ax.set_title("Router Training Curves")
    ax.legend()
    ax.grid(True, alpha=0.3)
    plt.tight_layout()
    path = Path(save_path) if save_path else Path(output_dir) / "training_curves.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return str(path)
