"""Router parity experiment: the counterpart of ``rag_uq_tpu/cli/parity.py``.

The reference publishes no benchmark numbers, so parity is measured by
running both systems on identical inputs. The router is the one reference
component that runs hermetically (pure torch, no external services), so
this experiment:

1. generates the seeded synthetic routing dataset (alternating BM25- and
   dense-favoring regimes, ``data/loaders.py::synthetic_router_data``);
2. trains the REFERENCE RetrievalRouter/RouterTrainer (torch, loaded from a
   reference checkout given with ``--reference``) and the port's
   ``RouterTrainer`` on the exact same arrays and schedule, the port's on
   the card unless ``--device cpu``;
3. reports final losses and hybrid hit@1 side by side, plus wall-clock.

Run: python3 -m rag_uq_tpu_torch.cli.parity [--reference CHECKOUT] [--device cpu]
The reference code is executed as-is (read-only import), never copied;
without ``--reference`` (or when the path does not exist) only the port's
arm runs. Trainer checkpoints go to a temporary directory.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from rag_uq_tpu_torch.core.config import TrainConfig
from rag_uq_tpu_torch.data.loaders import synthetic_router_data

logger = logging.getLogger(__name__)


def _load_reference_router(reference_path: str):
    """Import the reference's rag_uq.router module from its checkout."""
    path = Path(reference_path) / "rag_uq" / "router.py"
    spec = importlib.util.spec_from_file_location("reference_router", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["reference_router"] = module
    spec.loader.exec_module(module)
    return module


def _hit_at_1(rel: np.ndarray, top1: np.ndarray) -> float:
    return float(np.mean([rel[i, top1[i]] >= 0.5 for i in range(rel.shape[0])]))


def run_reference_arm(
    reference_path: str,
    train: tuple,
    val: tuple,
    epochs: int,
    batch_size: int,
) -> Dict:
    import torch

    ref = _load_reference_router(reference_path)
    torch.manual_seed(0)
    router = ref.RetrievalRouter(ref.RouterConfig())
    t_train = tuple(torch.tensor(a) for a in train)
    t_val = tuple(torch.tensor(a) for a in val)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = ref.RouterTrainer(router, checkpoint_dir=ckpt)
        t0 = time.time()
        history = trainer.fit(
            t_train, t_val, num_epochs=epochs, batch_size=batch_size,
            early_stopping_patience=10**9,  # fixed-epoch comparison
        )
        wall = time.time() - t0
    router.eval()
    with torch.no_grad():
        _scores, idx = router.hybrid_rerank(t_val[0], t_val[1], top_k=1)
    return {
        "final_train_loss": float(history["train_losses"][-1]),
        "final_val_loss": float(history["val_losses"][-1]),
        "val_hit_at_1": _hit_at_1(val[2], idx[:, 0].numpy()),
        "wall_clock_s": round(wall, 2),
        "impl": "reference (torch CPU)",
    }


def run_ours_arm(train: tuple, val: tuple, epochs: int, batch_size: int,
                 device: str = "cuda") -> Dict:
    from rag_uq_tpu_torch.router.model import RetrievalRouter
    from rag_uq_tpu_torch.router.train import RouterTrainer

    router = RetrievalRouter(seed=0, device=device)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = RouterTrainer(
            router,
            checkpoint_dir=ckpt,
            config=TrainConfig(
                num_epochs=epochs, batch_size=batch_size,
                early_stopping_patience=10**9,
                checkpoint_dir=ckpt,
            ),
        )
        t0 = time.time()
        history = trainer.fit(train, val)
        wall = time.time() - t0
    router.eval()
    _scores, idx = router.hybrid_rerank(val[0], val[1], top_k=1)
    return {
        "final_train_loss": float(history["train_losses"][-1]),
        "final_val_loss": float(history["val_losses"][-1]),
        "val_hit_at_1": _hit_at_1(val[2], idx[:, 0].cpu().numpy()),
        "wall_clock_s": round(wall, 2),
        "impl": f"rag_uq_tpu_torch ({router.device.type})",
    }


def run_parity(
    reference_path: Optional[str] = None,
    n_queries: int = 500,
    num_passages: int = 20,
    epochs: int = 20,
    batch_size: int = 16,
    output_path: Optional[str] = "results/router_parity_torch.json",
    skip_reference: bool = False,
    device: str = "cuda",
) -> Dict:
    bm25, dense, rel = synthetic_router_data(n_queries, num_passages, seed=42)
    split = int(0.8 * n_queries)
    train = (bm25[:split], dense[:split], rel[:split])
    val = (bm25[split:], dense[split:], rel[split:])

    report: Dict = {
        "dataset": {
            "n_queries": n_queries, "num_passages": num_passages,
            "epochs": epochs, "batch_size": batch_size, "seed": 42,
        }
    }
    report["ours"] = run_ours_arm(train, val, epochs, batch_size, device=device)
    if not skip_reference and reference_path and Path(reference_path).exists():
        try:
            report["reference"] = run_reference_arm(
                reference_path, train, val, epochs, batch_size
            )
        except Exception as e:  # pragma: no cover - depends on the checkout
            logger.exception("reference arm failed")
            report["reference"] = {"error": str(e)}
    logger.info("Parity report: %s", report)
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Router parity experiment")
    parser.add_argument("--reference", default=None,
                        help="a checkout of the reference (its rag_uq/router.py)")
    parser.add_argument("--n-queries", type=int, default=500)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--output", default="results/router_parity_torch.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(run_parity(
        reference_path=args.reference, n_queries=args.n_queries,
        epochs=args.epochs, output_path=args.output, device=args.device,
    ), indent=2))


if __name__ == "__main__":
    main()
