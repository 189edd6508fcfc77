"""End-to-end evaluation experiment: the counterpart of ``rag_uq_tpu/cli/evaluate.py``.

The held-out evaluation of the JAX package on the port: per chunk of
questions, retrieval (the union pool through ``get_scores_for_router_batch``,
whose dense pool is the hand-written top-k kernel on a card), an optional
router rerank clamped to the gate's trained pool width, contexts under the
concat or per_passage policy, batched generation, and confidence from the
UQ stack (MC sampling with its feature vector, conformal, or the length
heuristic), then the metric suite, plots and ``evaluation_results.json`` /
``predictions.jsonl`` in the JAX schema; with a labeled calibration split,
Platt, isotonic and multi-feature logistic scaling chosen on its held-out
tail. ``run_ablation_study`` runs the bm25-only, dense-only, fixed-hybrid
(fused and balanced pools), oracle and learned-router arms.

Retrieval metrics use the samples' ``gold_doc_ids`` where given, else
pseudo-gold ids: docs containing any gold answer substring. The answer
helpers (``build_qa_prompt``, ``select_best_candidate``,
``generate_answer``, ``generate_answer_per_passage``) serve ``/answer``.

The device is the retriever's: the MC estimator's answer embeddings go
there too. Timings are host clocks around work that ends on the host (the
retrieval scores and generated text come back as numpy and strings).

Run: ``python3 -m rag_uq_tpu_torch.cli.evaluate --nq-path nq.jsonl
--bm25-path data/bm25_index.json --dense-dir data/dense_index
[--router-checkpoint r.msgpack] [--mc-samples 8] [--ablation]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.data.loaders import load_qa_jsonl
from rag_uq_tpu_torch.eval import metrics as M
from rag_uq_tpu_torch.eval.evaluator import RAGEvaluator
from rag_uq_tpu_torch.eval.metrics import normalize_answer
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter, fuse_hybrid
from rag_uq_tpu_torch.router.train import load_router_checkpoint
from rag_uq_tpu_torch.uq.conformal import ConformalRAG
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.uq.scaling import (
    apply_isotonic,
    apply_logistic,
    apply_platt,
    fit_isotonic,
    fit_logistic,
    fit_platt,
)

logger = logging.getLogger(__name__)


def _trace(msg: str) -> None:
    """Stage-progress lines on stderr for long runs, when the environment
    sets RAG_UQ_EVAL_TRACE (as the JAX module does)."""
    if os.environ.get("RAG_UQ_EVAL_TRACE"):
        print(f"[eval {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


def build_qa_prompt(question: str, context: str) -> str:
    """The QA prompt template shared by evaluation and serving."""
    return (
        "Answer the question based on the context. Be concise.\n\n"
        f"Context: {context}\n\nQuestion: {question}\n\nAnswer:"
    )


def select_best_candidate(
    texts: Sequence[str],
    mean_lp: Sequence[float],
    contexts: Optional[Sequence[str]] = None,
) -> int:
    """Per-passage answer selection, lexicographic:

      1. non-blank beats blank;
      2. with ``contexts``, an answer found (normalized) in its own
         normalized passage beats one that is not;
      3. then the highest mean token log-probability;
      4. exact ties go to the first, the better retrieval rank.
    """
    lps = np.asarray(mean_lp, dtype=np.float64)
    blank = np.asarray([not (t or "").strip() for t in texts])
    if not blank.all():
        lps = np.where(blank, -np.inf, lps)
    if contexts is not None:
        grounded = np.asarray([
            bool(t) and normalize_answer(t) in normalize_answer(c or "")
            for t, c in zip(texts, contexts)
        ])
        if (grounded & ~blank).any():
            lps = np.where(grounded, lps, -np.inf)
    return int(np.argmax(lps))


def generate_answer(llm, question: str, context: str, max_tokens: int = 100) -> str:
    """Answer generation at temperature 0.1, top-p 0.9."""
    prompt = build_qa_prompt(question, context)
    return llm.generate(prompt, temperature=0.1, top_p=0.9, max_tokens=max_tokens)


def generate_answer_per_passage(
    llm, question: str, passages: Sequence[str],
    max_tokens: int = 100, max_context_chars: int = 2000,
) -> Tuple[str, str]:
    """One batched scored generation over the candidate passages, then
    ``select_best_candidate``. Returns (answer, winning passage). Falls back
    to the concat protocol (passages joined, clipped to
    ``max_context_chars``) when the generator has no scored path or no
    passage is non-empty."""
    cands = [p[:max_context_chars] for p in passages if p]
    if not cands or not hasattr(llm, "generate_batch_scored"):
        ctx = " ".join(p for p in passages if p)[:max_context_chars]
        return generate_answer(llm, question, ctx, max_tokens), ctx
    prompts = [build_qa_prompt(question, c) for c in cands]
    txts, mean_lp, _ = llm.generate_batch_scored(
        prompts, [0.1] * len(prompts), [0.9] * len(prompts),
        max_tokens=max_tokens,
    )
    best = select_best_candidate(txts, mean_lp, contexts=cands)
    return txts[best], cands[best]


def _pseudo_gold_ids(retriever: HybridRetriever, answers: List[str]) -> List[str]:
    """Docs whose text contains any gold answer (substring, lowercased)."""
    gold = []
    store = retriever.documents
    lowered = [a.lower() for a in answers if a]
    for pos in range(len(store)):
        text = store.texts[pos].lower()
        if any(a in text for a in lowered):
            gold.append(store.ids[pos])
    return gold


def _gold_ids_batch(
    retriever: HybridRetriever, samples: Sequence[dict]
) -> List[List[str]]:
    """Gold ids for every sample: real `gold_doc_ids` when the dataset
    provides them (e.g. synth_wiki worlds), else the answer-substring
    pseudo-gold — computed with the corpus lowered ONCE and memoized per
    answer rather than once per query."""
    out: List[Optional[List[str]]] = [None] * len(samples)
    need_scan = False
    for i, s in enumerate(samples):
        if s.get("gold_doc_ids"):
            out[i] = list(s["gold_doc_ids"])
        else:
            need_scan = True
    if need_scan:
        store = retriever.documents
        lowered_corpus = [store.texts[p].lower() for p in range(len(store))]
        memo: dict = {}
        for i, s in enumerate(samples):
            if out[i] is not None:
                continue
            answers = tuple(
                a.lower() for a in (s.get("answers") or [s.get("answer", "")]) if a
            )
            if answers not in memo:
                memo[answers] = [
                    store.ids[p]
                    for p, text in enumerate(lowered_corpus)
                    if any(a in text for a in answers)
                ]
            out[i] = memo[answers]
    return out  # type: ignore[return-value]


def _oracle_decisions(
    retriever: HybridRetriever,
    samples: Sequence[dict],
    top_k: int,
    gold: Optional[List[List[str]]] = None,
    b_pos: Optional[np.ndarray] = None,
    d_pos: Optional[np.ndarray] = None,
) -> List[int]:
    """Per-query oracle arm choice: 1 (dense) iff dense-only retrieval gets
    a strictly better reciprocal rank against the gold docs than bm25-only,
    0 iff bm25 is strictly better, -1 on ties (excluded from the accuracy
    denominator — when both arms rank gold identically there is nothing for
    a router to get right). Pass `b_pos`/`d_pos`/`gold` to reuse ablation
    arms."""
    questions = [s["question"] for s in samples]
    if gold is None:
        gold = _gold_ids_batch(retriever, samples)
    if b_pos is None:
        _, b_pos = retriever.bm25_index.search_batch(questions, top_k=top_k)
    if d_pos is None:
        _, d_pos = retriever.dense_index.search_batch(questions, top_k=top_k)
    store = retriever.documents
    out = []
    for i in range(len(questions)):
        b_ids = [store.ids[int(p)] for p in b_pos[i] if p >= 0]
        d_ids = [store.ids[int(p)] for p in d_pos[i] if p >= 0]
        rr_b = M.reciprocal_rank(b_ids, gold[i])
        rr_d = M.reciprocal_rank(d_ids, gold[i])
        out.append(1 if rr_d > rr_b else (0 if rr_b > rr_d else -1))
    return out


def _router_pool_width(router: RetrievalRouter, top_k: int) -> int:
    """Candidate-pool width for a router serving path: the width the gate
    was trained on (num_passages=20 reference protocol), widened only when
    more results than that are requested (the tail is then NOT router-scored
    — see _router_order); max(20, 2*top_k) would widen the gate's
    per-column input distribution for top_k > 10."""
    trained = getattr(router, "trained_num_passages", None)
    if trained is None:
        # Legacy checkpoints (pre-r4) don't record their trained pool
        # width; assuming the protocol default of 20 changes serving
        # behavior vs the old full-pool gate, so say so once per router.
        if not getattr(router, "_warned_default_width", False):
            logger.warning(
                "Router checkpoint lacks trained_num_passages; assuming the "
                "reference protocol width 20 for the gate clamp (legacy "
                "checkpoints were gated over the full pool)"
            )
            router._warned_default_width = True
        trained = 20
    return max(trained, top_k)


def _router_order(
    router: RetrievalRouter, bm25: np.ndarray, dense: np.ndarray
) -> tuple:
    """Router rerank clamped to the trained pool width.

    Scores only the first `trained_num_passages` columns (the fused-order
    head of the balanced pool — the distribution the gate was trained on)
    and reranks that head; any tail columns keep their pool order after the
    head. Returns (weights [B, head], order [B, P]) as numpy; the order is
    numpy's ``argsort`` of the fused scores, as in the JAX function."""
    P = bm25.shape[1]
    head = min(getattr(router, "trained_num_passages", None) or P, P)
    router.eval()
    w = router.forward(bm25[:, :head], dense[:, :head], update_stats=False)
    hybrid = _fuse(router, w, bm25, dense, head)
    order = np.argsort(-hybrid, axis=1)
    if head < P:
        tail = np.broadcast_to(
            np.arange(head, P), (bm25.shape[0], P - head)
        )
        order = np.concatenate([order, tail], axis=1)
    return w.cpu().numpy(), order


def _fuse(router: RetrievalRouter, w, bm25: np.ndarray, dense: np.ndarray,
          head: int) -> np.ndarray:
    """``fuse_hybrid`` of the router's head columns, in float32, as numpy."""
    def head_f32(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x[:, :head], dtype=np.float32),
                               device=router.device)

    w = torch.as_tensor(w, dtype=torch.float32, device=router.device)
    return fuse_hybrid(router.config, w, head_f32(bm25), head_f32(dense)).cpu().numpy()


def _predict_batch(
    retriever: HybridRetriever,
    samples: Sequence[dict],
    llm,
    router: Optional[RetrievalRouter],
    conformal: Optional[ConformalRAG],
    mc: Optional[MCDropoutConfidence],
    top_k: int,
    context_passages: int,
    max_context_chars: int,
    warm_start: bool = True,
    context_policy: str = "concat",
) -> Dict:
    """Shared batched predict path: retrieval -> contexts -> generation ->
    confidence, for a sample list. Used for both the test set and the
    labeled calibration split (Platt scaling).

    `context_policy` selects how retrieved passages become the generator's
    context:
      - "concat" (default): the reference protocol verbatim — top
        `context_passages` passages joined and clipped to
        `max_context_chars` (run_evaluation.py:157-212).
      - "per_passage": generate one answer per retrieved passage (the same
        `context_passages` head) and keep the answer with the highest mean
        token logprob (tie -> better retrieval rank). The JAX package's
        extraction-gap decomposition (runs/demo_full_r3/results/
        extraction_decomposition.json) motivates it: with this extractor,
        gold-passage-alone EM is 0.995 but 3-passage concat EM is 0.763
        even when gold is present. Per-passage turns B queries into B*P
        generation rows of one batched generate call, ~P× the generation
        FLOPs. Falls back to "concat" when the generator lacks
        `generate_batch_scored` (no selection signal). Downstream
        confidence (MC, grounding features) sees the WINNING passage as
        the context — the context actually answered from.

    With `warm_start` (default), each stage's first chunk runs once untimed
    before the timed region, so one-time costs (on a card: the kernel
    library's load, cuBLAS handles, the caching allocator's first blocks)
    land in `cold_start_ms` instead of the steady-state tail. The warm
    chunk's outputs are discarded and recomputed in the timed region, so
    every query's latency is a steady-state one.
    """
    samples = list(samples)
    n = len(samples)
    questions = [s["question"] for s in samples]
    cold_start: Dict[str, float] = {}

    # -- retrieval: chunked batched device passes + optional batched router
    # rerank. Each sub-batch is timed so per-query latency percentiles are
    # real (p99 != p50) — a query's cost is its sub-batch wall-clock
    # amortized over the sub-batch.
    retrieval_times: List[float] = []
    router_weights: List[float] = []
    retrieval_feats: List[List[float]] = []
    ids: List[List[str]] = []
    texts: List[List[str]] = []
    ret_chunk = 128
    if warm_start and n:
        _trace(f"retrieval warm-start (n={n})")
        t_w = time.time()
        warm_q = questions[:ret_chunk]
        warm_pool = (
            _router_pool_width(router, top_k)
            if router is not None
            else max(20, 2 * top_k)
        )
        wb, wd, _, _ = retriever.get_scores_for_router_batch(
            warm_q, num_passages=warm_pool,
            pool_order="balanced" if router is not None else "fused",
        )
        if router is not None:
            _router_order(router, wb, wd)
        cold_start["retrieval_ms"] = (time.time() - t_w) * 1000.0
    for s in range(0, n, ret_chunk):
        _trace(f"retrieval chunk {s}/{n}")
        t_r = time.time()
        chunk_q = questions[s : s + ret_chunk]
        # Router candidate pool at the width it was TRAINED on (the
        # reference's num_passages=20 protocol, router.py:520-561 /
        # train_router.py). With a router, the pool is selected "balanced"
        # (both towers' top ~P/2 survive; the router's serving-time candidate
        # policy) so a dense-only gold that fixed fusion mis-ranks past P can
        # still be rescued. WITHOUT a router this path is the reference's
        # fixed-fusion protocol and must use the fused pool head verbatim
        # (streaming_index.py:510-521) — a balanced pool can drop a
        # both-towers-mediocre candidate that fused ranking keeps, which
        # would silently change the no-router baseline.
        pool_p = (
            _router_pool_width(router, top_k)
            if router is not None
            else max(20, 2 * top_k)
        )
        bm25, dense, c_ids, c_texts = retriever.get_scores_for_router_batch(
            chunk_q, num_passages=pool_p,
            pool_order="balanced" if router is not None else "fused",
        )
        if router is not None:
            weights, order = _router_order(router, bm25, dense)
            head = weights.shape[1]
            # Ranking-score features come from the router-scored head,
            # through the SAME fuse policy the ranking used.
            hybrid = _fuse(router, weights, bm25, dense, head)
            c_ids = [[row[j] for j in order[i]] for i, row in enumerate(c_ids)]
            c_texts = [[row[j] for j in order[i]] for i, row in enumerate(c_texts)]
            router_weights.extend(float(w) for w in weights.mean(axis=1))
        else:
            max_b = np.maximum(bm25.max(axis=1, keepdims=True), 1e-12)
            max_d = np.maximum(dense.max(axis=1, keepdims=True), 1e-12)
            hybrid = (bm25 / max_b + dense / max_d) / 2.0
        # Retrieval-margin features for multi-feature confidence calibration
        # (uq/scaling.fit_logistic): top-1 ranking score and top1-top2 gap.
        h_sorted = -np.sort(-hybrid, axis=1)
        for row in h_sorted:
            retrieval_feats.append([
                float(row[0]),
                float(row[0] - row[1]) if row.shape[0] > 1 else 0.0,
            ])
        ids.extend(row[:top_k] for row in c_ids)
        texts.extend(row[:top_k] for row in c_texts)
        retrieval_times.extend([(time.time() - t_r) / len(chunk_q)] * len(chunk_q))
    retrieval_total = float(sum(retrieval_times))

    contexts = [
        " ".join(t for t in row[:context_passages] if t)[:max_context_chars]
        for row in texts
    ]
    per_passage = (
        context_policy == "per_passage"
        and hasattr(llm, "generate_batch_scored")
    )
    winning_slot: List[Optional[int]] = [None] * n
    if per_passage:
        # Per-query candidate contexts: the same retrieved head the concat
        # policy would join, one generation row each (empty slots dropped;
        # a query with no retrieved text falls back to its concat context).
        # Each candidate keeps its slot index in the retrieved head so the
        # WINNING passage's doc id is reportable downstream.
        pp_ctx = [
            [
                (j, t[:max_context_chars])
                for j, t in enumerate(row[:context_passages])
                if t
            ]
            or [(None, contexts[i])]
            for i, row in enumerate(texts)
        ]

    _prompt = build_qa_prompt  # single template definition for all paths

    # -- generation: chunked batched sampling (one device program per chunk),
    # each chunk timed for the same per-query percentile accounting. When the
    # generator exposes sequence likelihoods (TinyLM.generate_batch_scored),
    # the greedy answer's mean/min token logprob come back for free and feed
    # the confidence feature vector — the signal family that sees inside the
    # generation (docs/calibration.md).
    predictions: List[str] = []
    gen_logprobs: List[List[float]] = []
    generation_times: List[float] = []
    scored = hasattr(llm, "generate_batch_scored")
    gen_chunk = 64
    if per_passage:
        # B queries become B*P rows of the SAME batched device program —
        # chunk by whole queries so per-query timing stays clean.
        q_per_chunk = max(1, gen_chunk // max(context_passages, 1))
        if warm_start and n:
            _trace("generation warm-start")
            t_w = time.time()
            warm = [
                _prompt(q, c)
                for q, cands in zip(
                    questions[:q_per_chunk], pp_ctx[:q_per_chunk]
                )
                for _, c in cands
            ]
            llm.generate_batch_scored(
                warm, [0.1] * len(warm), [0.9] * len(warm), max_tokens=100
            )
            cold_start["generation_ms"] = (time.time() - t_w) * 1000.0
        for s in range(0, n, q_per_chunk):
            _trace(f"generation chunk {s}/{n}")
            t_g = time.time()
            group = pp_ctx[s : s + q_per_chunk]
            flat = [
                _prompt(q, c)
                for q, cands in zip(questions[s : s + q_per_chunk], group)
                for _, c in cands
            ]
            txts, mean_lp, min_lp = llm.generate_batch_scored(
                flat, [0.1] * len(flat), [0.9] * len(flat), max_tokens=100
            )
            off = 0
            for i, cands in enumerate(group):
                k = len(cands)
                best = select_best_candidate(
                    txts[off : off + k], mean_lp[off : off + k],
                    contexts=[c for _, c in cands],
                )
                predictions.append(txts[off + best])
                gen_logprobs.append(
                    [float(mean_lp[off + best]), float(min_lp[off + best])]
                )
                # Downstream confidence (MC, grounding features) sees the
                # winning passage — the context actually answered from.
                winning_slot[s + i] = cands[best][0]
                contexts[s + i] = cands[best][1]
                off += k
            generation_times.extend(
                [(time.time() - t_g) / len(group)] * len(group)
            )
    else:
        if warm_start and n:
            _trace("generation warm-start")
            t_w = time.time()
            warm_prompts = [
                _prompt(q, c)
                for q, c in zip(questions[:gen_chunk], contexts[:gen_chunk])
            ]
            warm_t = [0.1] * len(warm_prompts)
            warm_p = [0.9] * len(warm_prompts)
            if scored:
                llm.generate_batch_scored(warm_prompts, warm_t, warm_p,
                                          max_tokens=100)
            else:
                llm.generate_batch(warm_prompts, warm_t, warm_p,
                                   max_tokens=100)
            cold_start["generation_ms"] = (time.time() - t_w) * 1000.0
        for s in range(0, n, gen_chunk):
            _trace(f"generation chunk {s}/{n}")
            t_g = time.time()
            chunk_q = questions[s : s + gen_chunk]
            chunk_c = contexts[s : s + gen_chunk]
            prompts = [_prompt(q, c) for q, c in zip(chunk_q, chunk_c)]
            temps = [0.1] * len(prompts)
            tops = [0.9] * len(prompts)
            if scored:
                txts, mean_lp, min_lp = llm.generate_batch_scored(
                    prompts, temps, tops, max_tokens=100
                )
                predictions.extend(txts)
                gen_logprobs.extend(
                    [float(m), float(mn)] for m, mn in zip(mean_lp, min_lp)
                )
            else:
                predictions.extend(
                    llm.generate_batch(prompts, temps, tops, max_tokens=100)
                )
                gen_logprobs.extend([[0.0, 0.0]] * len(prompts))
            generation_times.extend(
                [(time.time() - t_g) / len(chunk_q)] * len(chunk_q)
            )
    generation_total = float(sum(generation_times))

    # -- real UQ confidence instead of the reference's length placeholder.
    confidences: List[float] = []
    conf_features: List[List[float]] = []
    if mc is not None:
        # One B*K-sample device program per chunk instead of B separate
        # K-sample calls.
        mc_chunk = max(1, 256 // max(mc.n_samples, 1))
        if warm_start and n:
            _trace("mc warm-start")
            t_w = time.time()
            mc.get_confidence_batch(
                "Answer the question.",
                contexts[:mc_chunk],
                questions[:mc_chunk],
            )
            cold_start["mc_ms"] = (time.time() - t_w) * 1000.0
        for s in range(0, n, mc_chunk):
            _trace(f"mc chunk {s}/{n}")
            for j, r in enumerate(mc.get_confidence_batch(
                "Answer the question.",
                contexts[s : s + mc_chunk],
                questions[s : s + mc_chunk],
            )):
                confidences.append(r.confidence)
                md = r.metadata
                # Grounding features: an extractive answer that is absent
                # from its own retrieved context is almost surely wrong, and
                # greedy/MC-consensus disagreement flags unstable decodes.
                # Both are computable at test time (no gold needed) and are
                # the strongest correctness predictors in this regime — the
                # extractor's MC disagreement alone is near-binary.
                n_cons = normalize_answer(r.consensus_answer or "")
                n_greedy = normalize_answer(predictions[s + j] or "")
                n_ctx = normalize_answer(contexts[s + j] or "")
                conf_features.append([
                    r.confidence,
                    md.get("agreement_rate", 0.0),
                    r.lexical_diversity or 0.0,
                    md.get("answer_len_spread", 0.0),
                    md.get("answer_len_mean", 0.0),
                    1.0 if n_cons and n_cons in n_ctx else 0.0,
                    1.0 if n_greedy and n_greedy in n_ctx else 0.0,
                    1.0 if n_greedy and n_greedy == n_cons else 0.0,
                    *gen_logprobs[s + j],
                    md.get("sample_lp_mean", 0.0),
                    md.get("sample_lp_spread", 0.0),
                    *retrieval_feats[s + j],
                ])
    else:
        for question, context, pred in zip(questions, contexts, predictions):
            if conformal is not None:
                conf = conformal.predict_with_coverage(
                    question, context
                ).confidence
            else:
                conf = 1.0 - ConformalRAG.estimate_nonconformity(pred, context)
            confidences.append(conf)

    return {
        "questions": questions,
        "ids": ids,
        "contexts": contexts,
        "predictions": predictions,
        "confidences": confidences,
        "conf_features": conf_features,
        "router_weights": router_weights,
        "retrieval_times": retrieval_times,
        "generation_times": generation_times,
        "retrieval_total": retrieval_total,
        "generation_total": generation_total,
        "cold_start": cold_start,
        # Per-query slot index (into the retrieved head) of the passage the
        # generator answered from under per_passage; None = concat/fallback.
        "winning_slot": winning_slot,
    }


def run_evaluation(
    retriever: HybridRetriever,
    samples: Sequence[dict],
    llm=None,
    router: Optional[RetrievalRouter] = None,
    conformal: Optional[ConformalRAG] = None,
    mc_samples: int = 0,
    top_k: int = 10,
    context_passages: int = 3,
    max_context_chars: int = 2000,
    output_dir: str = "results",
    save: bool = True,
    calibration_samples: Optional[Sequence[dict]] = None,
    context_policy: str = "concat",
) -> Dict:
    """Batched evaluation through the device hot path.

    The reference loops query-by-query (run_evaluation.py:157-212); here the
    whole test set goes through ONE batched retrieval pass (union pool,
    fixed-fusion ranking, optional router rerank — same per-query semantics)
    and chunked `generate_batch` calls. Per-query latency is reported as the
    batch wall-clock divided by the batch size (the amortized per-query cost
    of the batched deployment path; the reference's numbers are serial
    per-query costs).

    With `calibration_samples` (a labeled held-out split disjoint from
    `samples`), reported confidences are Platt-scaled: the same predict
    path runs on the calibration split, p(correct | raw confidence) is fit
    there (uq/scaling.py), and test confidences are mapped through it. Raw
    ECE and the fitted (A, B) are reported under `confidence_scaling`.
    """
    llm = llm or MockLLM()
    evaluator = RAGEvaluator(output_dir=output_dir)
    mc = (
        MCDropoutConfidence(llm, n_samples=mc_samples, seed=0,
                            device=retriever.device)
        if mc_samples > 0
        else None
    )
    samples = list(samples)
    n = len(samples)
    pred = _predict_batch(
        retriever, samples, llm, router, conformal, mc,
        top_k, context_passages, max_context_chars,
        context_policy=context_policy,
    )
    questions = pred["questions"]
    ids = pred["ids"]
    predictions = pred["predictions"]
    confidences = pred["confidences"]
    router_weights = pred["router_weights"]
    retrieval_times = pred["retrieval_times"]
    generation_times = pred["generation_times"]
    all_answers = [s.get("answers") or [s.get("answer", "")] for s in samples]

    scaling_info = None
    if calibration_samples:
        cal = _predict_batch(
            retriever, list(calibration_samples), llm, router, conformal, mc,
            top_k, context_passages, max_context_chars,
            warm_start=False,  # the test pass above paid the one-time costs
            context_policy=context_policy,
        )
        # Correctness = match against ANY gold alias (first-alias-only
        # labels bias the fitted p(correct|score) low and
        # make raw_ece inconsistent with the headline metrics).
        cal_answers = [
            s.get("answers") or [s.get("answer", "")] for s in calibration_samples
        ]
        cal_correct = M.correctness_labels_multi(cal["predictions"], cal_answers)
        raw_ece = evaluator.evaluate_calibration(
            confidences, M.correctness_labels_multi(predictions, all_answers)
        ).ece

        # Three calibrators, selected on a held-out tail of the calibration
        # split (NOT the fit half, and never the test set): single-score
        # Platt, isotonic, and — when MC features exist — a multi-feature
        # logistic over (MC disagreement, consensus agreement rate, lexical
        # diversity, answer length stats, retrieval margin).
        n_cal = len(cal["confidences"])
        n_fit = max(int(0.8 * n_cal), 1)
        cal_conf = np.asarray(cal["confidences"], dtype=np.float64)
        cal_y = np.asarray(cal_correct, dtype=np.float64)
        candidates: Dict[str, Dict] = {}

        a, b = fit_platt(cal_conf[:n_fit], cal_y[:n_fit])
        candidates["platt"] = {
            "cal_sel": apply_platt(cal_conf[n_fit:], a, b),
            "test": apply_platt(confidences, a, b),
            "params": {"a": a, "b": b},
        }
        xs, gs = fit_isotonic(cal_conf[:n_fit], cal_y[:n_fit])
        candidates["isotonic"] = {
            "cal_sel": apply_isotonic(cal_conf[n_fit:], xs, gs),
            "test": apply_isotonic(confidences, xs, gs),
            "params": {"knots": int(len(xs))},
        }
        if cal.get("conf_features") and pred.get("conf_features"):
            cal_x = np.asarray(cal["conf_features"], dtype=np.float64)
            test_x = np.asarray(pred["conf_features"], dtype=np.float64)
            w = fit_logistic(cal_x[:n_fit], cal_y[:n_fit])
            # Keep artifacts self-describing: weight i belongs to
            # feature_names[i] (order assembled in _predict_batch); the
            # final weight is the bias.
            feat_names = [
                "mc_confidence", "agreement_rate", "lexical_diversity",
                "answer_len_spread", "answer_len_mean",
                "consensus_in_context", "greedy_in_context",
                "greedy_eq_consensus", "greedy_lp_mean", "greedy_lp_min",
                "sample_lp_mean", "sample_lp_spread",
                "retrieval_top1", "retrieval_margin",
            ]
            candidates["logistic_features"] = {
                "cal_sel": apply_logistic(cal_x[n_fit:], w),
                "test": apply_logistic(test_x, w),
                "params": {
                    "weights": [round(float(v), 4) for v in w],
                    "feature_names": feat_names[: cal_x.shape[1]] + ["bias"],
                },
            }

        def sel_brier(c) -> Optional[float]:
            if n_cal == n_fit:
                return None
            return float(np.mean((c["cal_sel"] - cal_y[n_fit:]) ** 2))

        # With an empty holdout tail every candidate would score an
        # identical 0.0 and min() pick by dict order. Make the
        # degenerate case explicit: no tail -> default to platt and say so.
        if n_cal == n_fit:
            method = "platt"
            selection_note = (
                "degenerate: calibration holdout tail empty (n_cal == n_fit); "
                "defaulted to platt"
            )
        else:
            method = min(candidates, key=lambda m: sel_brier(candidates[m]))
            selection_note = (
                f"brier on calibration holdout tail ({n_cal - n_fit} examples)"
            )
        confidences = [float(c) for c in candidates[method]["test"]]
        scaling_info = {
            "method": method,
            "selection": selection_note,
            "candidates": {
                m: {
                    "holdout_brier": (
                        None if sel_brier(c) is None else round(sel_brier(c), 4)
                    ),
                    **c["params"],
                }
                for m, c in candidates.items()
            },
            "n_calibration": n_cal,
            "cal_accuracy": float(np.mean(cal_correct)),
            "raw_ece": float(raw_ece),
        }

    latencies = [r + g for r, g in zip(retrieval_times, generation_times)]
    retrieved_ids = [[i for i in row if i] for row in ids]
    gold_ids = _gold_ids_batch(retriever, samples)
    # Alias-aware references: grade each prediction against its best-matching
    # gold answer (M.best_reference) so generation metrics agree with the
    # calibration labels above.
    references = [
        M.best_reference(p, a) for p, a in zip(predictions, all_answers)
    ]

    # Router-vs-oracle decision accuracy (reference eval_protocol.py:294-296
    # defines the metric; its caller never populates it — ours does): router
    # decision = 1 if the mean gate leans dense; oracle = which single arm
    # (bm25-only vs dense-only) ranks a gold doc higher for this query.
    router_decisions = oracle_decisions = None
    if router_weights:
        router_decisions = [1 if w > 0.5 else 0 for w in router_weights]
        oracle_decisions = _oracle_decisions(
            retriever, samples, top_k, gold=gold_ids
        )

    results = evaluator.run_full_evaluation(
        retrieved_ids=retrieved_ids,
        gold_ids=gold_ids,
        predictions=predictions,
        references=references,
        confidences=confidences,
        latencies=latencies,
        router_weights=router_weights or None,
        router_decisions=router_decisions,
        oracle_decisions=oracle_decisions,
        save_results=save,
    )
    eff = evaluator.evaluate_efficiency(
        latencies, retrieval_times=retrieval_times, generation_times=generation_times
    )
    results["efficiency"] = eff.to_dict()
    # Cold-start cost reported as its own field, never inside the
    # steady-state percentiles. Schema seam:
    # reference eval_protocol.py:469-505.
    cold = pred.get("cold_start") or {}
    results["efficiency"]["cold_start_ms"] = {
        **{k: round(v, 1) for k, v in cold.items()},
        "total": round(sum(cold.values()), 1),
    }
    # Per-slice generation + end-to-end decomposition (where does EM go
    # relative to retrieval recall?): available whenever samples carry
    # `metadata.slice` labels, mirroring the ablation's by_slice contract.
    sl_labels = [(s.get("metadata") or {}).get("slice") for s in samples]
    if len({s for s in sl_labels if s}) >= 2:
        # Candidate-set rate: gold anywhere in the retrieved head the
        # policy draws from.
        gold_in_cands = [
            1.0 if any(g in row[:context_passages] for g in gset) else 0.0
            for row, gset in zip(retrieved_ids, gold_ids)
        ]
        # Effective rate: gold in the context the generator actually
        # answered from — equal to the candidate rate under concat, but the
        # single WINNING passage under per_passage.
        win = pred.get("winning_slot") or [None] * len(samples)
        gold_in_ctx = [
            (
                1.0 if w is not None and w < len(ids[i])
                and ids[i][w] in gold_ids[i] else 0.0
            )
            if win[i] is not None
            else gold_in_cands[i]
            for i, w in enumerate(win)
        ]
        pp_engaged = any(w is not None for w in win)
        by_slice: Dict[str, Dict] = {}
        for sl in sorted({s for s in sl_labels if s}):
            idx = [i for i, s in enumerate(sl_labels) if s == sl]
            g = evaluator.evaluate_generation(
                [predictions[i] for i in idx], [references[i] for i in idx]
            )
            r = evaluator.evaluate_retrieval(
                [retrieved_ids[i] for i in idx], [gold_ids[i] for i in idx]
            )
            by_slice[sl] = {
                "n": len(idx),
                "exact_match": g.exact_match,
                "f1": g.f1,
                "mrr": r.mrr,
                "recall_at_10": r.recall_at_k.get(10),
                "gold_in_context_rate": float(
                    np.mean([gold_in_ctx[i] for i in idx])
                ),
            }
            if pp_engaged:
                by_slice[sl]["gold_in_candidates_rate"] = float(
                    np.mean([gold_in_cands[i] for i in idx])
                )
        results["generation"]["by_slice"] = by_slice
    if scaling_info is not None:
        results["confidence_scaling"] = scaling_info
    # Self-describing artifact: which context policy produced these numbers
    # (and whether per_passage actually engaged or fell back to concat).
    results["protocol"] = {
        "context_policy": context_policy,
        "context_policy_effective": (
            context_policy
            if context_policy == "concat"
            or hasattr(llm, "generate_batch_scored")
            else "concat"
        ),
        "context_passages": context_passages,
        "top_k": top_k,
    }
    if save:
        with open(Path(output_dir) / "evaluation_results.json", "w") as f:
            json.dump(results, f, indent=2)
        # Per-example records so slices/conditions can be analyzed post-hoc
        # without re-running the (generation-dominated) eval pass.
        with open(Path(output_dir) / "predictions.jsonl", "w") as f:
            for i, s in enumerate(samples):
                f.write(json.dumps({
                    "id": s.get("id"),
                    "question": questions[i],
                    "prediction": predictions[i],
                    "references": all_answers[i],
                    "retrieved_ids": list(retrieved_ids[i]),
                    "gold_ids": list(gold_ids[i]),
                    "confidence": float(confidences[i]),
                    "slice": sl_labels[i] if sl_labels else None,
                }) + "\n")
    return results


def run_ablation_study(
    retriever: HybridRetriever,
    samples: Sequence[dict],
    llm=None,
    router: Optional[RetrievalRouter] = None,
    top_k: int = 10,
    output_dir: str = "results/ablation",
) -> Dict[str, Dict]:
    """Four retrieval arms (implemented, unlike the reference's TODO stub):
    bm25-only, dense-only, fixed-weight hybrid, learned router.

    When samples carry `metadata.slice` labels (e.g. synth_wiki's
    "lexical" vs "semantic" paraphrase-stress split), every arm is also
    reported per slice under `by_slice` — the evidence surface for
    "dense beats bm25 on semantic, bm25 beats dense on lexical, learned
    routing wins overall"."""
    llm = llm or MockLLM()
    evaluator = RAGEvaluator(output_dir=output_dir)
    arms: Dict[str, Dict] = {}
    samples = list(samples)
    questions = [s["question"] for s in samples]
    slices = [
        (s.get("metadata") or {}).get("slice") for s in samples
    ]
    slice_names = sorted({s for s in slices if s})
    if len(slice_names) < 2:
        slice_names = []

    # Gold ids depend only on (corpus, answers): compute once, reuse per arm.
    gold = _gold_ids_batch(retriever, samples)
    store = retriever.documents

    def ids_of(pos_rows: np.ndarray) -> List[List[str]]:
        return [
            [store.ids[int(p)] for p in row if p >= 0] for row in pos_rows
        ]

    def eval_arm(name: str, retrieved: List[List[str]], **kw) -> None:
        arms[name] = evaluator.evaluate_retrieval(retrieved, gold, **kw).to_dict()
        if slice_names:
            arms[name]["by_slice"] = {}
            for sl in slice_names:
                idx = [i for i, s in enumerate(slices) if s == sl]
                arms[name]["by_slice"][sl] = evaluator.evaluate_retrieval(
                    [retrieved[i] for i in idx], [gold[i] for i in idx]
                ).to_dict()
                arms[name]["by_slice"][sl]["n"] = len(idx)

    # Every arm is one batched device pass over the whole test set.
    _, b_pos = retriever.bm25_index.search_batch(questions, top_k=top_k)
    eval_arm("bm25_only", ids_of(b_pos))
    _, d_pos = retriever.dense_index.search_batch(questions, top_k=top_k)
    eval_arm("dense_only", ids_of(d_pos))
    # fixed_hybrid is the reference protocol verbatim: the head of the
    # fused-ranked union pool (streaming_index.py:510-521). The router arm
    # gets its own "balanced" candidate pool (both towers' top ~P/2 survive
    # selection — the router's serving-time candidate policy); comparing the
    # two arms therefore compares the full deployed policies, not two
    # rerankings of one pool. Both arms report top_k lists.
    pool_p = (
        _router_pool_width(router, top_k)
        if router is not None
        else max(20, 2 * top_k)
    )
    _, _, f_ids, _ = retriever.get_scores_for_router_batch(
        questions, num_passages=pool_p, pool_order="fused"
    )
    eval_arm("fixed_hybrid", [[i for i in row[:top_k] if i] for row in f_ids])
    # fixed_hybrid_balanced: fixed mean fusion over the SAME balanced pool
    # the router arm uses. The router arm changes
    # two variables vs fixed_hybrid — the gate AND the candidate pool; this
    # control isolates them: learned_router − fixed_hybrid_balanced is the
    # gate's contribution, fixed_hybrid_balanced − fixed_hybrid is the pool
    # policy's.
    bal_b, bal_d, bal_ids, _ = retriever.get_scores_for_router_batch(
        questions, num_passages=pool_p, pool_order="balanced"
    )
    max_b = np.maximum(bal_b.max(axis=1, keepdims=True), 1e-12)
    max_d = np.maximum(bal_d.max(axis=1, keepdims=True), 1e-12)
    bal_fused = (bal_b / max_b + bal_d / max_d) / 2.0
    bal_order = np.argsort(-bal_fused, axis=1)
    eval_arm(
        "fixed_hybrid_balanced",
        [[bal_ids[i][j] for j in bal_order[i] if bal_ids[i][j]][:top_k]
         for i in range(len(bal_ids))],
    )
    # oracle_router: per-query best SINGLE arm (the routing ceiling a binary
    # bm25/dense gate could reach). Decision source is
    # _oracle_decisions (gold reciprocal rank per arm); ties take either arm
    # (identical RR by construction). Publishing this makes the router's
    # decision accuracy convertible into "captures X% of the oracle's MRR
    # headroom over the best fixed arm". Reference metric seam:
    # eval_protocol.py:294-296.
    oracle = _oracle_decisions(
        retriever, samples, top_k, gold=gold, b_pos=b_pos, d_pos=d_pos
    )
    b_ids_all, d_ids_all = ids_of(b_pos), ids_of(d_pos)
    eval_arm(
        "oracle_router",
        [d_ids_all[i] if oracle[i] == 1 else b_ids_all[i]
         for i in range(len(questions))],
    )
    if router is not None:
        ids = bal_ids
        # Rerank clamped to the gate's trained pool width.
        w, order = _router_order(router, bal_b, bal_d)
        # Router-vs-oracle accuracy, reusing the single-arm results above.
        decisions = [1 if float(x) > 0.5 else 0 for x in w.mean(axis=1)]
        eval_arm(
            "learned_router",
            [[ids[i][j] for j in order[i] if ids[i][j]][:top_k]
             for i in range(len(ids))],
            router_decisions=decisions,
            oracle_decisions=oracle,
        )
        # Headroom capture summary: what fraction of the oracle's MRR gain
        # over the best fixed arm does the learned router realize?
        best_fixed = max(
            arms[a]["mrr"] for a in
            ("bm25_only", "dense_only", "fixed_hybrid", "fixed_hybrid_balanced")
        )
        oracle_gain = arms["oracle_router"]["mrr"] - best_fixed
        router_gain = arms["learned_router"]["mrr"] - best_fixed
        arms["headroom"] = {
            "best_fixed_mrr": best_fixed,
            "oracle_mrr": arms["oracle_router"]["mrr"],
            "router_mrr": arms["learned_router"]["mrr"],
            "oracle_headroom": oracle_gain,
            "router_capture": (
                router_gain / oracle_gain if oracle_gain > 1e-9 else None
            ),
        }

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(output_dir) / "ablation_results.json", "w") as f:
        json.dump(arms, f, indent=2)
    return arms


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="End-to-end RAG evaluation")
    parser.add_argument("--nq-path", default="data/preprocessed/nq_dev_3000.jsonl")
    parser.add_argument("--skip", type=int, default=500,
                        help="test split starts after this many samples")
    parser.add_argument("--n-test", type=int, default=200)
    parser.add_argument("--router-checkpoint", default=None)
    parser.add_argument("--mc-samples", type=int, default=0)
    parser.add_argument("--bm25-path", default="./data/bm25_index.json")
    parser.add_argument("--dense-dir", default="./data/dense_index")
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--ablation", action="store_true")
    parser.add_argument("--context-policy", default="concat",
                        choices=("concat", "per_passage"),
                        help="How retrieved passages become generator "
                        "context: reference-verbatim concat, or one "
                        "generation row per passage with logprob selection")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    all_samples = load_qa_jsonl(args.nq_path)
    samples = all_samples[args.skip : args.skip + args.n_test]

    retriever = HybridRetriever(
        bm25_persist_path=args.bm25_path,
        dense_persist_directory=args.dense_dir,
        device=args.device,
    )
    router = None
    if args.router_checkpoint:
        router = RetrievalRouter(device=args.device)
        load_router_checkpoint(router, args.router_checkpoint)

    results = run_evaluation(
        retriever, samples, router=router,
        mc_samples=args.mc_samples, output_dir=args.output_dir,
        context_policy=args.context_policy,
    )
    print(json.dumps(results["summary"], indent=2))
    if args.ablation:
        print(json.dumps(
            run_ablation_study(retriever, samples, router=router,
                               output_dir=str(Path(args.output_dir) / "ablation")),
            indent=2,
        ))


if __name__ == "__main__":
    main()
