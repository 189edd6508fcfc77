"""End-to-end parity harness: the counterpart of ``rag_uq_tpu/cli/parity_e2e.py``.

The reference publishes no numbers, so parity is measured by running BOTH
systems on identical inputs. ``cli/parity.py`` covers the router; this
harness covers the remaining protocol end to end:

1. **Retrieval head-to-head**: the same synthetic-wikipedia corpus and the
   same held-out questions go through the REFERENCE ``HybridRetriever``
   (its code executed as-is from a checkout given with ``--reference``,
   with the port's clean-room shims for its missing
   ``rank_bm25``/``chromadb`` dependencies and its own documented SHA-256
   offline embedding fallback, streaming_index.py:267-273) and through the
   port's retriever, on the card unless ``--device cpu``: once with the
   same SHA-256 embedder (machinery-parity arm) and once with the trained
   encoder (capability arm). recall@k / precision@k / MRR / NDCG@10 are
   computed by the same metric code (the port's) for all arms.
2. **Conformal coverage head-to-head**: both systems' ``ConformalRAG``
   calibrate on identical (question, context, answer) triples and are
   tested on an identical held-out set, with an identical deterministic
   generator (a seeded context-span echo: same prompt -> same answer in
   both systems, so differences reflect only the conformal machinery).
   Reports each system's threshold and empirical coverage at alpha = 0.1.

Run: python3 -m rag_uq_tpu_torch.cli.parity_e2e --reference CHECKOUT
[--device cpu]  ->  runs/parity_torch/e2e_parity.json
Protocol parity: the reference's rag_uq/streaming_index.py:464-523 and
confidence.py:405-561.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import logging
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _load_reference_module(reference_path: str, rel: str, name: str):
    """Execute a reference module from its checkout (read-only, as-is)."""
    from rag_uq_tpu_torch.compat import install_shims

    install_shims()
    path = Path(reference_path) / rel
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


# -- deterministic shared generator ------------------------------------------------


def _extract_context(prompt: str) -> str:
    if "Context: " in prompt:
        ctx = prompt.split("Context: ", 1)[1]
        return ctx.split("\n\nQuestion:", 1)[0]
    return prompt


def span_echo_answer(prompt: str) -> str:
    """Deterministic pseudo-answer: the prompt's context with seeded random
    word deletions (keep prob in [0.85, 1.0) per example). The seed is a
    hash of the prompt, so the reference arm and our arm produce
    byte-identical 'generations' for identical inputs — any coverage
    difference is then attributable to the conformal machinery, not the
    generator. The deletion policy makes the nonconformity distribution
    1 - ROUGE-L(pred, truth) continuous with a small (~5%) atom at 1.0, so
    the finite-sample quantile and the empirical coverage are both
    informative (an always-miss generator would degenerate to threshold 1.0
    and trivial 100% coverage)."""
    words = _extract_context(prompt).split()
    if not words:
        return ""
    seed = int(hashlib.md5(prompt.encode()).hexdigest()[:8], 16)
    rng = np.random.default_rng(seed)
    keep = 0.85 + 0.15 * rng.random()
    kept = [w for w in words if rng.random() < keep]
    return " ".join(kept) if kept else words[0]


class OllamaStyleEcho:
    """Reference-side client: ollama.Client API (generate -> {'response'})."""

    def generate(self, model=None, prompt="", options=None):
        return {"response": span_echo_answer(prompt)}


class GeneratorStyleEcho:
    """Our-side client: the Generator protocol (llm/base.py)."""

    def generate(self, prompt, temperature=0.1, top_p=0.9, max_tokens=100,
                 seed=None):
        return span_echo_answer(prompt)

    def generate_batch(self, prompts, temperatures, top_ps, max_tokens=100,
                       seed=None):
        return [span_echo_answer(p) for p in prompts]


# -- retrieval arms -----------------------------------------------------------------


def _run_reference_retrieval(
    reference_path: str,
    corpus_rows: Sequence[Dict],
    questions: Sequence[str],
    top_k: int,
) -> Dict[str, List[List[str]]]:
    """Index the corpus with the reference HybridRetriever and search."""
    ref_si = _load_reference_module(
        reference_path, "rag_uq/streaming_index.py", "reference_streaming_index"
    )
    with tempfile.TemporaryDirectory() as tmp:
        retriever = ref_si.HybridRetriever(
            bm25_persist_path=None,
            chroma_persist_path=str(Path(tmp) / "chroma"),
        )
        docs = [
            ref_si.Document(id=r["id"], text=r["text"], title=r.get("title"))
            for r in corpus_rows
        ]
        # One add call: the reference rebuilds BM25Okapi per add_documents
        # call (streaming_index.py:141-142), so batching avoids its O(N^2)
        # build pathology without changing behavior.
        #
        # REFERENCE BUG (found by this harness): HybridRetriever.add_documents
        # guards with `if self.bm25_index:` / `if self.dense_index:`
        # (streaming_index.py:442,445) intending a None check, but both index
        # classes define __len__, so a FRESH (empty) index is falsy and the
        # guard skips indexing entirely — from-scratch ingest stores nothing.
        # To compare retrieval at all, populate the store and call the two
        # index objects' own add_documents directly (their code, unmodified),
        # which is what the guard would have done had the indices been
        # non-empty.
        t0 = time.time()
        for d in docs:
            retriever.documents[d.id] = d
        retriever.bm25_index.add_documents(docs)
        retriever.dense_index.add_documents(docs)
        build_s = time.time() - t0
        t0 = time.time()
        hybrid, bm25_only, dense_only = [], [], []
        for q in questions:
            hybrid.append(
                [r.doc_id for r in retriever.hybrid_search(q, top_k=top_k)]
            )
            bm25_only.append([d for d, _ in retriever.bm25_search(q, top_k=top_k)])
            dense_only.append(
                [d for d, _, _ in retriever.dense_index.search(q, top_k=top_k)]
            )
        query_s = time.time() - t0
    return {"hybrid": hybrid, "bm25_only": bm25_only, "dense_only": dense_only,
            "build_s": round(build_s, 1), "query_s": round(query_s, 1)}


def _run_our_retrieval(
    corpus_rows: Sequence[Dict],
    questions: Sequence[str],
    top_k: int,
    embedder,
    device: str = "cuda",
) -> Dict[str, List[List[str]]]:
    from rag_uq_tpu_torch.core.types import Document
    from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

    t0 = time.time()
    retriever = HybridRetriever(embedder=embedder, device=device)
    retriever.add_documents(
        [Document(r["id"], r["text"], r.get("title")) for r in corpus_rows]
    )
    build_s = time.time() - t0
    store = retriever.documents
    # The first batched pass pays the one-time costs (on the card: the
    # kernels' nvcc build and the caching allocator's growth); run the full
    # batch once timed as compile+first and once again for the steady-state
    # query number, so the per-arm timings are comparable to the
    # reference's, which has no such phase.
    t0 = time.time()
    retriever.get_scores_for_router_batch(list(questions), num_passages=top_k)
    retriever.bm25_index.search_batch(list(questions), top_k=top_k)
    retriever.dense_index.search_batch(list(questions), top_k=top_k)
    compile_s = time.time() - t0
    t0 = time.time()
    _b, _d, ids, _t = retriever.get_scores_for_router_batch(
        list(questions), num_passages=top_k
    )
    hybrid = [[i for i in row if i] for row in ids]
    _, b_pos = retriever.bm25_index.search_batch(list(questions), top_k=top_k)
    _, d_pos = retriever.dense_index.search_batch(list(questions), top_k=top_k)
    query_s = time.time() - t0
    as_ids = lambda rows: [
        [store.ids[int(p)] for p in row if p >= 0] for row in rows
    ]
    return {"hybrid": hybrid, "bm25_only": as_ids(b_pos),
            "dense_only": as_ids(d_pos),
            "build_s": round(build_s, 1), "compile_s": round(compile_s, 1),
            "query_s": round(query_s, 1)}


# -- conformal coverage arms ---------------------------------------------------------


def _coverage(conformal, rouge_fn, threshold: float,
              test: Sequence[Dict]) -> Dict:
    """Empirical coverage: fraction of test examples whose TRUE nonconformity
    1 - ROUGE-L(prediction, truth) falls at or below the calibrated
    threshold (the event the split-conformal guarantee bounds)."""
    covered = 0
    for s in test:
        pred = span_echo_answer(_prompt_of(s))
        score = 1.0 - rouge_fn(pred, s["answers"][0])
        if score <= threshold + 1e-12:
            covered += 1
    return {"coverage": covered / max(len(test), 1), "threshold": threshold,
            "n_test": len(test)}


def _prompt_of(s: Dict) -> str:
    # Both systems' prompt template (ours is a parity contract with
    # confidence.py:386-394), so the echo generator sees identical bytes.
    return (
        "Answer the following question based on the provided context.\n"
        "Be concise and precise.\n\n"
        f"Context: {s['context']}\n\nQuestion: {s['question']}\n\nAnswer:"
    )


def run_e2e_parity(
    reference_path: str,
    n_articles: int = 4000,
    top_k: int = 10,
    n_cal: int = 1000,
    n_test: int = 2000,
    alpha: float = 0.1,
    encoder_checkpoint: Optional[str] = "models/encoder/encoder.msgpack",
    output_path: Optional[str] = "runs/parity_torch/e2e_parity.json",
    max_retrieval_queries: int = 800,
    device: str = "cuda",
) -> Dict:
    from rag_uq_tpu_torch.cli.train_encoder import split_by_entity
    from rag_uq_tpu_torch.core.device import resolve_device
    from rag_uq_tpu_torch.data.synth_wiki import generate_world
    from rag_uq_tpu_torch.embed.hash_embed import Sha256Embedder
    from rag_uq_tpu_torch.eval.evaluator import RAGEvaluator

    device = resolve_device(device)  # before any work: no card, no run
    world = generate_world(n_articles, seed=0)
    corpus_rows = world.corpus_rows()
    qa_rows = world.qa_rows()
    # Retrieval queries = the same held-out-entity split the encoder
    # experiment evaluates on (no train/test leakage for the trained arm).
    train_qa, held_qa = split_by_entity(qa_rows, 0.1)
    held_qa = held_qa[:max_retrieval_queries]
    questions = [q["question"] for q in held_qa]
    gold = [q["gold_doc_ids"] for q in held_qa]

    report: Dict = {
        "protocol": {
            "n_articles": n_articles, "n_queries": len(questions),
            "top_k": top_k, "n_cal": n_cal, "n_test": n_test, "alpha": alpha,
            "generator": "deterministic shared span-echo",
            "reference_embedding": "sha256 offline fallback "
                                   "(streaming_index.py:267-273)",
        }
    }

    # -- retrieval ----------------------------------------------------------------
    # Timings are reported per arm, split into build / compile / query.
    ref_arms = _run_reference_retrieval(
        reference_path, corpus_rows, questions, top_k
    )
    our_sha = _run_our_retrieval(
        corpus_rows, questions, top_k, Sha256Embedder(dim=384), device=device
    )
    ours_trained = None
    if encoder_checkpoint and Path(encoder_checkpoint).exists():
        from rag_uq_tpu_torch.embed.train import load_encoder_checkpoint

        ours_trained = _run_our_retrieval(
            corpus_rows, questions, top_k,
            load_encoder_checkpoint(encoder_checkpoint, device=device),
            device=device,
        )
    report["retrieval_timings_s"] = {
        "reference": {k: ref_arms[k] for k in ("build_s", "query_s")},
        "ours_sha256": {
            k: our_sha[k] for k in ("build_s", "compile_s", "query_s")
        },
    }
    if ours_trained is not None:
        report["retrieval_timings_s"]["ours_trained_encoder"] = {
            k: ours_trained[k] for k in ("build_s", "compile_s", "query_s")
        }

    with tempfile.TemporaryDirectory() as eval_dir:
        evaluator = RAGEvaluator(output_dir=eval_dir)

        def metrics(retrieved: List[List[str]]) -> Dict:
            m = evaluator.evaluate_retrieval(retrieved, gold, k_values=[1, 5, 10])
            out = {"mrr": m.mrr, "ndcg@10": m.ndcg_at_10}
            out.update({f"recall@{k}": v for k, v in m.recall_at_k.items()})
            out.update({f"precision@{k}": v for k, v in m.precision_at_k.items()})
            return out

        report["retrieval"] = {}
        for arm in ("hybrid", "bm25_only", "dense_only"):
            report["retrieval"][arm] = {
                "reference": metrics(ref_arms[arm]),
                "ours_sha256": metrics(our_sha[arm]),
            }
            if ours_trained is not None:
                report["retrieval"][arm]["ours_trained_encoder"] = metrics(
                    ours_trained[arm]
                )

    # -- conformal coverage --------------------------------------------------------
    uq_pool = [q for q in train_qa if q["answers"][0]]
    cal = uq_pool[:n_cal]
    test = uq_pool[n_cal : n_cal + n_test]
    cal_q = [s["question"] for s in cal]
    cal_ctx = [s["context"] for s in cal]
    cal_ans = [s["answers"][0] for s in cal]

    ref_conf_mod = _load_reference_module(
        reference_path, "rag_uq/confidence.py", "reference_confidence"
    )
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ref_conf = ref_conf_mod.ConformalRAG(
            OllamaStyleEcho(),
            calibration_db_path=str(Path(tmp) / "ref_cal.db"),
            alpha=alpha,
        )
        ref_conf.calibrate(cal_q, cal_ctx, cal_ans)
        ref_cov = _coverage(
            ref_conf, ref_conf.rouge_l, ref_conf.get_conformal_threshold(), test
        )
        ref_cov["calibrate_s"] = round(time.time() - t0, 1)

        from rag_uq_tpu_torch.uq.conformal import ConformalRAG

        t0 = time.time()
        our_conf = ConformalRAG(
            GeneratorStyleEcho(),
            calibration_db_path=str(Path(tmp) / "our_cal.db"),
            alpha=alpha,
            device=device,
        )
        our_conf.calibrate(cal_q, cal_ctx, cal_ans)
        our_cov = _coverage(
            our_conf, our_conf.rouge_l, our_conf.get_conformal_threshold(), test
        )
        our_cov["calibrate_s"] = round(time.time() - t0, 1)

    report["conformal"] = {
        "target_coverage": 1 - alpha,
        "reference": ref_cov,
        "ours": our_cov,
    }

    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(report, f, indent=2)
    logger.info("e2e parity report written to %s", output_path)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="End-to-end parity harness")
    parser.add_argument("--reference", required=True,
                        help="a checkout of the reference (its rag_uq/ package)")
    parser.add_argument("--articles", type=int, default=4000)
    parser.add_argument("--n-cal", type=int, default=1000)
    parser.add_argument("--n-test", type=int, default=2000)
    parser.add_argument("--encoder-checkpoint",
                        default="models/encoder/encoder.msgpack")
    parser.add_argument("--output", default="runs/parity_torch/e2e_parity.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = run_e2e_parity(
        reference_path=args.reference, n_articles=args.articles,
        n_cal=args.n_cal, n_test=args.n_test,
        encoder_checkpoint=args.encoder_checkpoint, output_path=args.output,
        device=args.device,
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
