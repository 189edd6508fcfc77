"""Router-training experiment: the counterpart of ``rag_uq_tpu/cli/train_router.py``.

``prepare_training_data`` scores each batch of questions on the device
(``HybridRetriever.get_scores_for_router_batch`` with the balanced pool,
whose dense pool is the hand-written top-k kernel) and labels each passage
with its best pseudo-relevance over the sample's answers, aligned with the
score columns. ``train_router`` fits a router (``router/train.py``), scores
validation hit@1 and writes ``training_results.json`` and
``final_router.msgpack`` as the JAX CLI does; the training-curves PNG
(``eval/plots.py``) waits for the evaluation slice. ``--synthetic`` runs
the seeded alternating-regime experiment without an index.

Run: ``python3 -m rag_uq_tpu_torch.cli.train_router --synthetic
[--device cpu]``, or with ``--nq-path``, ``--bm25-path`` and ``--dense-dir``
for an index built by either package.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from rag_uq_tpu_torch.core.config import RouterConfig, TrainConfig
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.data.loaders import load_qa_jsonl, synthetic_router_data
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.labels import aligned_pseudo_labels
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.train import RouterTrainer

logger = logging.getLogger(__name__)

TrainData = Tuple[np.ndarray, np.ndarray, np.ndarray]


def prepare_training_data(
    retriever: HybridRetriever,
    samples: Sequence[dict],
    num_passages: int = 20,
    batch_size: int = 512,
) -> TrainData:
    """Retrieval scores + pseudo-labels, one device pass a batch."""
    samples = list(samples)
    bm25_all, dense_all, rel_all = [], [], []
    for s in range(0, len(samples), batch_size):
        chunk = samples[s : s + batch_size]
        bm25, dense, _ids, texts = retriever.get_scores_for_router_batch(
            [c["question"] for c in chunk], num_passages=num_passages,
            pool_order="balanced",
        )
        for i, sample in enumerate(chunk):
            answers = sample.get("answers") or [sample.get("answer", "")]
            labels = np.zeros(num_passages, dtype=np.float32)
            for ans in answers:
                labels = np.maximum(labels, aligned_pseudo_labels(texts[i], ans))
            bm25_all.append(np.asarray(bm25[i], dtype=np.float32))
            dense_all.append(np.asarray(dense[i], dtype=np.float32))
            rel_all.append(labels)
    return (
        np.asarray(bm25_all, dtype=np.float32),
        np.asarray(dense_all, dtype=np.float32),
        np.asarray(rel_all, dtype=np.float32),
    )


def evaluate_hit_at_1(router: RetrievalRouter, bm25: np.ndarray, dense: np.ndarray,
                      rel: np.ndarray) -> float:
    """Fraction of queries whose top-1 hybrid passage has relevance >= 0.5."""
    router.eval()
    _scores, idx = router.hybrid_rerank(bm25, dense, top_k=1)
    top1 = idx.cpu().numpy()[:, 0]
    return float(np.mean([rel[i, top1[i]] >= 0.5 for i in range(rel.shape[0])]))


def train_router(
    train_data: TrainData,
    val_data: TrainData,
    router_config: Optional[RouterConfig] = None,
    train_config: Optional[TrainConfig] = None,
    output_dir: str = "models/router",
    device: DeviceLike = "cuda",
) -> dict:
    """Fit the router and write the results JSON and the final checkpoint."""
    cfg = train_config or TrainConfig(checkpoint_dir=output_dir)
    router = RetrievalRouter(router_config, device=device)
    trainer = RouterTrainer(router, config=cfg, checkpoint_dir=output_dir)

    t0 = time.time()
    history = trainer.fit(train_data, val_data)
    wall = time.time() - t0

    hit1 = evaluate_hit_at_1(router, *val_data)
    results = {
        "final_train_loss": history["train_losses"][-1],
        "final_val_loss": history["val_losses"][-1] if history["val_losses"] else None,
        "epochs_trained": len(history["train_losses"]),
        "val_hit_at_1": hit1,
        "wall_clock_seconds": wall,
        "num_parameters": router.num_params(),
    }
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "training_results.json", "w") as f:
        json.dump(results, f, indent=2)
    trainer.save_checkpoint(str(out / "final_router.msgpack"))
    logger.info("Router training done: %s", results)
    return results


def run_synthetic_experiment(
    n_queries: int = 500,
    num_passages: int = 20,
    output_dir: str = "models/router",
    train_config: Optional[TrainConfig] = None,
    seed: int = 42,
    device: DeviceLike = "cuda",
) -> dict:
    """Seeded synthetic experiment: an 80/20 split of
    ``synthetic_router_data``."""
    bm25, dense, rel = synthetic_router_data(n_queries, num_passages, seed)
    split = int(0.8 * n_queries)
    return train_router(
        (bm25[:split], dense[:split], rel[:split]),
        (bm25[split:], dense[split:], rel[split:]),
        train_config=train_config,
        output_dir=output_dir,
        device=device,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Train the retrieval router")
    parser.add_argument("--nq-path", default="data/preprocessed/nq_dev_3000.jsonl")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--n-samples", type=int, default=3000)
    parser.add_argument("--num-passages", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--output-dir", default="models/router")
    parser.add_argument("--bm25-path", default="./data/bm25_index.json")
    parser.add_argument("--dense-dir", default="./data/dense_index")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = TrainConfig(
        learning_rate=args.lr,
        num_epochs=args.epochs,
        batch_size=args.batch_size,
        checkpoint_dir=args.output_dir,
    )
    if args.synthetic:
        run_synthetic_experiment(output_dir=args.output_dir, train_config=cfg, device=args.device)
        return

    samples = load_qa_jsonl(args.nq_path, limit=args.n_samples)
    retriever = HybridRetriever(
        bm25_persist_path=args.bm25_path,
        dense_persist_directory=args.dense_dir,
        device=args.device,
    )
    split = int(0.9 * len(samples))
    train = prepare_training_data(retriever, samples[:split], args.num_passages)
    val = prepare_training_data(retriever, samples[split:], args.num_passages)
    train_router(train, val, train_config=cfg, output_dir=args.output_dir, device=args.device)


if __name__ == "__main__":
    main()
