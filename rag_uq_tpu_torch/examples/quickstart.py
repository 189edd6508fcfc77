"""End-to-end quickstart: index -> hybrid search -> router -> UQ -> eval.

The port's counterpart of ``examples/quickstart.py``: drives the whole
pipeline through the public ``rag_uq_tpu_torch`` API on a small corpus, on
the card (``--device cuda``, the default) or the CPU (``--device cpu``).

Run: ``python3 -m rag_uq_tpu_torch.examples.quickstart [--device cpu]``.
"""

import argparse
import json
import tempfile
import time

import numpy as np

from rag_uq_tpu_torch import (
    ConformalRAG,
    HybridRetriever,
    MCDropoutConfidence,
    MockLLM,
    RAGEvaluator,
    RetrievalRouter,
    RouterTrainer,
    StreamingIndex,
    TinyLM,
    create_pseudo_labels,
)
from rag_uq_tpu_torch.core.config import DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.llm.tiny_lm import TinyLMConfig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="End-to-end quickstart")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    device = parser.parse_args(argv).device
    with tempfile.TemporaryDirectory(prefix="rag_uq_tpu_torch_quickstart_") as tmp:
        run(tmp, device)


def run(tmp: str, device: str) -> None:
    print(f"workdir: {tmp}")

    # --- 1. Corpus + streaming indexed ingest -------------------------------
    facts = [
        ("paris", "Paris is the capital of France and home to the Eiffel Tower."),
        ("everest", "Mount Everest is the tallest mountain on Earth at 8849 meters."),
        ("python", "Python is a programming language created by Guido van Rossum."),
        ("whale", "The blue whale is the largest animal that has ever lived."),
        ("sun", "The Sun is a main-sequence star at the center of the Solar System."),
        ("nile", "The Nile is the longest river in Africa."),
        ("jupiter", "Jupiter is the largest planet in the Solar System."),
        ("tokyo", "Tokyo is the capital of Japan and its most populous city."),
    ]
    corpus_path = f"{tmp}/corpus.jsonl"
    with open(corpus_path, "w") as f:
        for doc_id, text in facts:
            f.write(json.dumps({"id": doc_id, "text": text}) + "\n")
        f.write("this line is malformed json\n")

    retriever = HybridRetriever(
        dense_config=DenseIndexConfig(embedding_dim=128, score_block=1024),
        embedder_config=EmbedderConfig(dim=128, vocab_hash_buckets=8192),
        device=device,
    )
    indexer = StreamingIndex(retriever, checkpoint_path=f"{tmp}/ckpt.json", batch_size=4)
    for n in indexer.stream_from_jsonl(corpus_path):
        print(f"indexed batch of {n}")
    print("progress:", indexer.get_progress())

    # --- 2. Hybrid search ----------------------------------------------------
    t0 = time.time()
    results = retriever.hybrid_search("what is the capital of France", top_k=3)
    print(f"hybrid search ({(time.time()-t0)*1e3:.1f} ms):")
    for r in results:
        print(f"  {r.doc_id}: bm25={r.bm25_score:.3f} dense={r.dense_score:.3f} "
              f"hybrid={r.hybrid_score:.3f}")
    assert results[0].doc_id == "paris", "expected paris at rank 1"

    # --- 3. Router training on synthetic routing data ------------------------
    rng = np.random.default_rng(0)
    n, p = 200, 16
    bm25 = rng.normal(size=(n, p)).astype(np.float32)
    dense = rng.normal(size=(n, p)).astype(np.float32)
    # dense is informative: relevance follows dense scores
    rel = (dense > 0.8).astype(np.float32)
    router = RetrievalRouter(device=device)
    trainer = RouterTrainer(router, checkpoint_dir=f"{tmp}/router")
    history = trainer.fit(
        (bm25[:160], dense[:160], rel[:160]),
        (bm25[160:], dense[160:], rel[160:]),
        num_epochs=10,
        batch_size=16,
    )
    print("router train losses:", [round(x, 4) for x in history["train_losses"][:3]],
          "->", round(history["train_losses"][-1], 4))

    router.eval()
    scores, idx = router.hybrid_rerank(bm25[:2], dense[:2], top_k=5)
    print("rerank top-5 idx:", idx.cpu().numpy())
    decision = router.get_routing_decision(bm25[:2], dense[:2])
    print(f"avg dense weight: {decision['avg_dense_weight']:.3f}")

    # labels path
    labels = create_pseudo_labels(["the answer is paris", "nope"], ["paris here"],
                                  "paris", num_passages=4)
    print("pseudo labels:", labels)

    # --- 4. UQ: MC sampling + conformal with a mock LLM -----------------------
    llm = MockLLM(["Paris.", "It is Paris.", "paris", "The capital is Paris."])
    mc = MCDropoutConfidence(llm, n_samples=6, seed=0, device=device)
    conf = mc.get_confidence_interval(
        "Answer the question.", results[0].text, "What is the capital of France?"
    )
    print(f"MC consensus={conf.consensus_answer!r} confidence={conf.confidence:.3f}")

    conformal = ConformalRAG(llm, calibration_db_path=f"{tmp}/cal.db", alpha=0.1,
                             device=device)
    stats = conformal.calibrate(
        [f"q{i}" for i in range(20)],
        [f"context {i}" for i in range(20)],
        ["Paris."] * 20,
    )
    print("calibration:", {k: stats[k] for k in ("total_calibrated", "skipped")})
    pred = conformal.predict_with_coverage("What is the capital?", "Paris is the capital.")
    print(f"conformal: reliable={pred.is_reliable} p={pred.p_value:.3f} "
          f"threshold={pred.metadata['threshold']:.3f}")

    # --- 4b. Batched fused search + on-device generation -----------------------
    vals, pos = retriever.hybrid_search_batch(
        ["capital of France", "largest planet", "longest river in africa"],
        top_k=3,
    )
    print("fused batched top-1 ids:",
          [retriever.documents.ids[p[0]] for p in pos if p[0] >= 0])

    lm = TinyLM(TinyLMConfig(dim=64, num_layers=2, num_heads=4, mlp_dim=128,
                             max_prompt_len=64, max_total_len=128), device=device)
    samples = lm.generate_batch(["hello"] * 4, [0.7, 0.9, 1.0, 1.1],
                                [0.9] * 4, max_tokens=8, seed=0)
    print(f"TinyLM sampling on {device}: {len(samples)} samples")

    # --- 5. Evaluation protocol ------------------------------------------------
    evaluator = RAGEvaluator(output_dir=f"{tmp}/results")
    report = evaluator.run_full_evaluation(
        retrieved_ids=[[r.doc_id for r in results]],
        gold_ids=[["paris"]],
        predictions=[conf.consensus_answer],
        references=["Paris"],
        confidences=[conf.confidence],
        latencies=[0.01],
        router_weights=[float(decision["avg_dense_weight"])],
    )
    print("eval summary:", report["summary"])
    print("OK: end-to-end pipeline complete")


if __name__ == "__main__":
    main()
