"""Index-build CLI: the counterpart of ``rag_uq_tpu/cli/build_index.py``.

Streams a corpus JSONL into the hybrid index with checkpoint/resume
(``index/build.py::StreamingIndex``), saves both indices once at the end in
the JAX package's format, and verifies with sample queries reporting index
sizes and top hits. ``build_index_from_jsonl`` takes the root ``Config`` as
the JAX function does, and the device.

    python3 -m rag_uq_tpu_torch.cli.build_index --corpus corpus.jsonl \\
        --bm25-path data/bm25_index.json --dense-dir data/dense_index --verify
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence

from rag_uq_tpu_torch.core.config import Config
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.index.build import StreamingIndex
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

logger = logging.getLogger(__name__)


def build_index_from_jsonl(
    corpus_path: str,
    checkpoint_path: str = "./data/index_checkpoint.json",
    bm25_persist_path: Optional[str] = "./data/bm25_index.json",
    dense_persist_directory: Optional[str] = "./data/dense_index",
    batch_size: int = 100,
    resume: bool = True,
    config: Optional[Config] = None,
    device: DeviceLike = "cuda",
) -> HybridRetriever:
    cfg = config or Config()
    retriever = HybridRetriever(
        bm25_persist_path=bm25_persist_path,
        dense_persist_directory=dense_persist_directory,
        bm25_config=cfg.bm25,
        dense_config=cfg.dense,
        embedder_config=cfg.embedder,
        device=device,
    )
    # Stream without per-batch persistence (O(N^2) disk writes otherwise);
    # the line-offset checkpoint still lands after every batch, and the
    # index is saved once at the end.
    retriever.bm25_index.autosave = False
    indexer = StreamingIndex(retriever, checkpoint_path=checkpoint_path,
                             batch_size=batch_size)
    total = sum(indexer.stream_from_jsonl(corpus_path, resume=resume))
    logger.info("Indexed %d new documents (total %d)", total, len(retriever))
    if bm25_persist_path and total:
        retriever.bm25_index.save()
    if dense_persist_directory:
        retriever.dense_index.save(dense_persist_directory)
    return retriever


def verify_index(
    retriever: HybridRetriever,
    sample_queries: Optional[Sequence[str]] = None,
) -> dict:
    """Run sample queries and report sizes and top hits."""
    queries = list(sample_queries or [
        "what is machine learning",
        "capital city of a country",
        "history of science",
    ])
    report = {
        "total_documents": len(retriever),
        "bm25_documents": len(retriever.bm25_index),
        "dense_documents": len(retriever.dense_index),
        "queries": {},
    }
    for q in queries:
        hits = retriever.hybrid_search(q, top_k=3)
        report["queries"][q] = [
            {"doc_id": r.doc_id, "hybrid_score": r.hybrid_score} for r in hits
        ]
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Build the hybrid index")
    parser.add_argument("--corpus", required=True, help="corpus JSONL path")
    parser.add_argument("--checkpoint", default="./data/index_checkpoint.json")
    parser.add_argument("--bm25-path", default="./data/bm25_index.json")
    parser.add_argument("--dense-dir", default="./data/dense_index")
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--verify", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    retriever = build_index_from_jsonl(
        args.corpus,
        checkpoint_path=args.checkpoint,
        bm25_persist_path=args.bm25_path,
        dense_persist_directory=args.dense_dir,
        batch_size=args.batch_size,
        resume=not args.no_resume,
        device=args.device,
    )
    if args.verify:
        print(json.dumps(verify_index(retriever), indent=2))


if __name__ == "__main__":
    main()
