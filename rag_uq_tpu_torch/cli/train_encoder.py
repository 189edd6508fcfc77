"""Encoder training experiment: the counterpart of ``rag_uq_tpu/cli/train_encoder.py``.

Contrastive InfoNCE over (question, gold passage) pairs (``embed/train.py``)
on the QA rows of entities the held-out split never asks about, then dense
recall@k on the held-out questions for the trained encoder, the same
encoder untrained (same init seed), ``NgramHashEmbedder`` and
``Sha256Embedder``. Recall runs through ``DenseIndex.search_batch``, on the
card the hand-written top-k kernel. Writes ``encoder.msgpack`` (loadable by
either package's ``load_encoder_checkpoint``) and ``encoder_results.json``.

Run: ``python3 -m rag_uq_tpu_torch.cli.train_encoder [--corpus c.jsonl --qa
q.jsonl | --articles N] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

from rag_uq_tpu_torch.core.config import DenseIndexConfig
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder, Sha256Embedder
from rag_uq_tpu_torch.embed.train import ContrastiveTrainer, EncoderTrainConfig
from rag_uq_tpu_torch.index.dense import DenseIndex

logger = logging.getLogger(__name__)


def dense_recall_at_k(
    embedder,
    corpus_rows: Sequence[Dict],
    qa_rows: Sequence[Dict],
    k: int = 10,
    batch_size: int = 512,
    device: DeviceLike = "cuda",
) -> float:
    """Fraction of questions whose gold doc id is in the dense top-k."""
    index = DenseIndex(
        embedder=embedder,
        config=DenseIndexConfig(embedding_dim=embedder.dim),
        device=device,
    )
    index.add_documents(
        [Document(r["id"], r["text"], r.get("title")) for r in corpus_rows],
        batch_size=batch_size,
    )
    hits = 0
    questions = [q["question"] for q in qa_rows]
    for s in range(0, len(questions), batch_size):
        chunk = qa_rows[s : s + batch_size]
        _, pos = index.search_batch(questions[s : s + batch_size], top_k=k)
        for row, q in zip(pos, chunk):
            got = {index.store.ids[int(p)] for p in row if p >= 0}
            if got & set(q["gold_doc_ids"]):
                hits += 1
    return hits / max(len(qa_rows), 1)


def split_by_entity(qa_rows: Sequence[Dict], holdout_fraction: float = 0.1):
    """Split QAs so held-out questions target entities never queried in
    training (unseen names, unseen question instances)."""
    gold_keys = sorted({q["gold_doc_ids"][0] for q in qa_rows})
    n_hold = max(1, int(len(gold_keys) * holdout_fraction))
    held = set(gold_keys[::  max(len(gold_keys) // n_hold, 1)][:n_hold])
    train = [q for q in qa_rows if q["gold_doc_ids"][0] not in held]
    heldout = [q for q in qa_rows if q["gold_doc_ids"][0] in held]
    return train, heldout


def train_encoder(
    corpus_rows: Sequence[Dict],
    qa_rows: Sequence[Dict],
    output_dir: str = "models/encoder",
    encoder_config: Optional[EncoderConfig] = None,
    train_config: Optional[EncoderTrainConfig] = None,
    eval_k: int = 10,
    holdout_fraction: float = 0.1,
    device: DeviceLike = "cuda",
) -> Dict:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    enc_cfg = encoder_config or EncoderConfig(
        dim=256, num_layers=2, num_heads=8, mlp_dim=1024,
        max_seq_len=64, vocab_buckets=1 << 14,
    )
    cfg = train_config or EncoderTrainConfig()

    train_qa, held_qa = split_by_entity(qa_rows, holdout_fraction)
    logger.info(
        "Training on %d pairs, holding out %d questions over unseen entities",
        len(train_qa), len(held_qa),
    )

    trainer = ContrastiveTrainer(config=cfg, encoder_config=enc_cfg, device=device)
    # Random-init recall first (the ablation baseline shares the init seed).
    t0 = time.time()
    recall_untrained = dense_recall_at_k(
        TransformerEmbedder(enc_cfg, seed=cfg.seed, device=device), corpus_rows, held_qa,
        eval_k, device=device,
    )
    losses = trainer.fit(
        [q["question"] for q in train_qa],
        [q["context"] for q in train_qa],
    )
    train_secs = time.time() - t0

    embedder = trainer.export_embedder()
    recall_trained = dense_recall_at_k(embedder, corpus_rows, held_qa, eval_k, device=device)
    recall_ngram = dense_recall_at_k(
        NgramHashEmbedder(dim=enc_cfg.dim, device=device), corpus_rows, held_qa, eval_k,
        device=device,
    )
    recall_sha = dense_recall_at_k(
        Sha256Embedder(dim=384), corpus_rows, held_qa, eval_k, device=device
    )

    ckpt = str(out / "encoder.msgpack")
    trainer.save_checkpoint(ckpt)
    results = {
        "n_corpus": len(corpus_rows),
        "n_train_pairs": len(train_qa),
        "n_heldout": len(held_qa),
        "steps": len(losses),
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "train_seconds": round(train_secs, 1),
        f"dense_recall@{eval_k}": {
            "trained_encoder": recall_trained,
            "untrained_encoder": recall_untrained,
            "ngram_hash": recall_ngram,
            "sha256_reference_fallback": recall_sha,
        },
        "checkpoint": ckpt,
        "encoder_config": vars(enc_cfg),
    }
    with open(out / "encoder_results.json", "w") as f:
        json.dump(results, f, indent=2)
    logger.info("Encoder results: %s", json.dumps(results, indent=2))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Train the dense encoder")
    parser.add_argument("--corpus", default=None, help="corpus JSONL")
    parser.add_argument("--qa", default=None, help="QA JSONL with gold_doc_ids")
    parser.add_argument("--articles", type=int, default=2000,
                        help="generate a synth_wiki world of this size when "
                        "no --corpus is given")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--output-dir", default="models/encoder")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.corpus and args.qa:
        from rag_uq_tpu_torch.data.loaders import load_qa_jsonl, read_jsonl

        corpus_rows = list(read_jsonl(args.corpus))
        qa_rows = [q for q in load_qa_jsonl(args.qa) if q.get("gold_doc_ids")]
    else:
        from rag_uq_tpu_torch.data.synth_wiki import generate_world

        world = generate_world(args.articles, seed=args.seed)
        corpus_rows = world.corpus_rows()
        qa_rows = world.qa_rows()

    enc_cfg = EncoderConfig(
        dim=args.dim, num_layers=args.layers,
        num_heads=max(args.dim // 32, 1), mlp_dim=4 * args.dim,
        max_seq_len=64, vocab_buckets=1 << 14,
    )
    cfg = EncoderTrainConfig(total_steps=args.steps, batch_size=args.batch_size, seed=args.seed)
    results = train_encoder(
        corpus_rows, qa_rows, output_dir=args.output_dir,
        encoder_config=enc_cfg, train_config=cfg, device=args.device,
    )
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
