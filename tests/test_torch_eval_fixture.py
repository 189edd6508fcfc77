"""The evaluation fixture ``tests/data/torch_eval_fixture.json``, held to its
sources.

The fixture is the anchor of ``chip_smoke.py``'s ``eval`` phase: the JAX
pipeline's step 6 (``cli/evaluate.py::run_evaluation`` with the demo run's
encoder, ``router/final_router.msgpack`` and ``models/tiny_lm_r5``) over the
first 200 questions of the demo's test window, ``nq.jsonl`` rows [500, 700).
For each question it holds the id, the slice, the gold doc ids, the demo's
prediction (``runs/demo_full_r4/results/predictions.jsonl``, whose 1,000 ids
are rows [500, 1500)) and the top-10 ids the current JAX package retrieves
(``get_scores_for_router_batch``'s balanced pool at the router's trained
width, then ``_router_order``), with the encoder and the dense index in
float32 on the CPU, and the router's and the oracle's arm choices
(``_router_order``'s mean gate, ``_oracle_decisions``). The demo's own
``retrieved_ids`` are not used for retrieval: the current package, in
float32 on the CPU, reproduces 112 of those 200 lists (the others differ by
swaps and members deep in the list; the top-1 ids agree for 195), and
``demo_lists_equal`` records that count. The metrics are the JAX metric
functions' over the fixture's fields.

The test checks the fixture's fields against ``nq.jsonl`` and
``predictions.jsonl``, recomputes the metrics, and reruns the JAX retrieval
for the first ``N_CHECKED`` questions (about 40 s on the CPU, most of it
embedding the corpus). To regenerate all of it (about 60 s):

    RAG_UQ_TPU_TORCH_WRITE_FIXTURE=1 JAX_PLATFORMS=cpu \\
        python -m pytest tests/test_torch_eval_fixture.py -q
"""

import dataclasses
import json
import os
from pathlib import Path

from rag_uq_tpu.cli import evaluate as jax_evaluate
from rag_uq_tpu.eval import metrics as jax_metrics

FIXTURE = Path(__file__).parent / "data" / "torch_eval_fixture.json"
RUN = "runs/demo_full_r4"
ROWS, N_CHECKED, TOP_K = (500, 700), 32, 10


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _test_rows():
    return _read_jsonl(f"{RUN}/nq.jsonl")[ROWS[0] : ROWS[1]]


def _demo_predictions():
    return _read_jsonl(f"{RUN}/results/predictions.jsonl")[: ROWS[1] - ROWS[0]]


def _jax_retriever_and_router():
    """The demo index in the JAX package, encoder and dense index in float32."""
    from rag_uq_tpu.core.config import DenseIndexConfig
    from rag_uq_tpu.core.types import Document
    from rag_uq_tpu.embed.encoder import TransformerEmbedder
    from rag_uq_tpu.embed.train import load_encoder_checkpoint
    from rag_uq_tpu.retrieval.hybrid import HybridRetriever
    from rag_uq_tpu.router.model import RetrievalRouter
    from rag_uq_tpu.router.train import RouterTrainer

    saved = load_encoder_checkpoint(f"{RUN}/encoder/encoder.msgpack")
    encoder = TransformerEmbedder(dataclasses.replace(saved.config, dtype="float32"))
    encoder.load_params(saved.params)
    retriever = HybridRetriever(
        embedder=encoder, dense_config=DenseIndexConfig(embedding_dim=256, dtype="float32"))
    retriever.add_documents([Document.from_dict(r) for r in _read_jsonl(f"{RUN}/corpus.jsonl")])
    router = RetrievalRouter()
    RouterTrainer(router).load_checkpoint(f"{RUN}/router/final_router.msgpack")
    return retriever, router


def _jax_retrieval(retriever, router, rows):
    """(top-10 ids, router decisions) as run_evaluation computes them, in
    its chunks of 128 questions."""
    retrieved, decisions = [], []
    width = jax_evaluate._router_pool_width(router, TOP_K)
    for s in range(0, len(rows), 128):
        chunk = [r["question"] for r in rows[s : s + 128]]
        bm25, dense, ids, _ = retriever.get_scores_for_router_batch(
            chunk, num_passages=width, pool_order="balanced")
        weights, order = jax_evaluate._router_order(router, bm25, dense)
        retrieved += [[row[j] for j in order[i] if row[j]][:TOP_K] for i, row in enumerate(ids)]
        decisions += [1 if float(w) > 0.5 else 0 for w in weights.mean(axis=1)]
    return retrieved, decisions


def _metrics(records, answers):
    retrieval = jax_metrics.evaluate_retrieval(
        [r["retrieved_ids"] for r in records], [r["gold_ids"] for r in records],
        router_decisions=[r["router_decision"] for r in records],
        oracle_decisions=[r["oracle_decision"] for r in records])
    preds = [r["prediction"] for r in records]
    refs = [jax_metrics.best_reference(p, a) for p, a in zip(preds, answers)]
    return {
        "recall@1": retrieval.recall_at_k[1], "recall@5": retrieval.recall_at_k[5],
        "recall@10": retrieval.recall_at_k[10], "mrr": retrieval.mrr,
        "ndcg@10": retrieval.ndcg_at_10, "router_accuracy": retrieval.router_accuracy,
        "exact_match": jax_metrics.evaluate_generation(preds, refs).exact_match,
    }


def _write_fixture():
    rows, demo = _test_rows(), _demo_predictions()
    retriever, router = _jax_retriever_and_router()
    retrieved, decisions = _jax_retrieval(retriever, router, rows)
    samples = [{"question": r["question"], "gold_doc_ids": r["gold_doc_ids"]} for r in rows]
    oracle = jax_evaluate._oracle_decisions(retriever, samples, TOP_K)
    records = [{
        "id": r["id"], "slice": r["metadata"]["slice"], "gold_ids": r["gold_doc_ids"],
        "prediction": d["prediction"], "retrieved_ids": ids, "router_decision": dec,
        "oracle_decision": orc,
    } for r, d, ids, dec, orc in zip(rows, demo, retrieved, decisions, oracle)]
    FIXTURE.write_text(json.dumps({
        "source": f"{RUN}/nq.jsonl rows {list(ROWS)}; predictions from "
                  f"{RUN}/results/predictions.jsonl; retrieval from the JAX package "
                  f"(float32, CPU) with {RUN}/encoder and {RUN}/router/final_router.msgpack",
        "rows": list(ROWS), "top_k": TOP_K,
        "demo_lists_equal": sum(r["retrieved_ids"] == d["retrieved_ids"]
                                for r, d in zip(records, demo)),
        "metrics": _metrics(records, [r["answers"] for r in rows]),
        "records": records,
    }, indent=1) + "\n")


def test_eval_fixture_matches_its_sources():
    if os.environ.get("RAG_UQ_TPU_TORCH_WRITE_FIXTURE"):
        _write_fixture()
    fx = json.loads(FIXTURE.read_text())
    rows, demo = _test_rows(), _demo_predictions()
    records = fx["records"]
    assert [r["id"] for r in records] == [r["id"] for r in rows] == [d["id"] for d in demo]
    assert [r["slice"] for r in records] == [r["metadata"]["slice"] for r in rows] == \
        [d["slice"] for d in demo]
    assert [r["gold_ids"] for r in records] == [r["gold_doc_ids"] for r in rows] == \
        [d["gold_ids"] for d in demo]
    assert [r["prediction"] for r in records] == [d["prediction"] for d in demo]
    assert fx["demo_lists_equal"] == sum(
        r["retrieved_ids"] == d["retrieved_ids"] for r, d in zip(records, demo))
    assert fx["metrics"] == _metrics(records, [r["answers"] for r in rows])

    retriever, router = _jax_retriever_and_router()
    retrieved, decisions = _jax_retrieval(retriever, router, rows[:N_CHECKED])
    assert retrieved == [r["retrieved_ids"] for r in records[:N_CHECKED]]
    assert decisions == [r["router_decision"] for r in records[:N_CHECKED]]
    samples = [{"question": r["question"], "gold_doc_ids": r["gold_doc_ids"]}
               for r in rows[:N_CHECKED]]
    assert jax_evaluate._oracle_decisions(retriever, samples, TOP_K) == \
        [r["oracle_decision"] for r in records[:N_CHECKED]]
