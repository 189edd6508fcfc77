"""The answer fixture ``tests/data/torch_answer_fixture.json``, kept current
against the JAX package, and the port's greedy answers held to it.

The fixture holds the first 32 questions of ``runs/demo_full_r4/nq.jsonl``
with their gold answers, the top-1 passage that the JAX server's retrieval
serves for each (``QueryService`` with the demo run's encoder and router over
its 5,000-passage corpus), and the JAX TinyLM's (``models/tiny_lm_r5``)
greedy answer (top-p 1e-6 keeps only the most likely token) to the QA prompt
of that passage, with its mean log-probability. ``chip_smoke.py`` holds the
port on the card to it: at least 28 of the 32 greedy answers equal, room
for bf16 argmax flips where two logits are within rounding.

The test reruns the JAX greedy decoding of the first ``N_CHECKED`` stored
prompts in one batch and asserts the file is current there: XLA on the CPU
takes about 30 s for 4 prompts and over 3 minutes for all 32 (611 decode
steps of the 512-byte prompt bucket, each over the whole 1280-position
cache). To regenerate the whole fixture, retrieval and all 32 answers
included (about 6 minutes):

    RAG_UQ_TPU_TORCH_WRITE_FIXTURE=1 JAX_PLATFORMS=cpu \\
        python -m pytest tests/test_torch_answer_fixture.py -q

The port's own retrieval of the fixture's contexts is held to the JAX
package's in ``tests/test_torch_demo_retrieval.py``.
"""

import json
import os
from pathlib import Path

import numpy as np

from rag_uq_tpu.cli.evaluate import build_qa_prompt as jax_build_qa_prompt
from rag_uq_tpu.eval.metrics import exact_match as jax_exact_match
from rag_uq_tpu.llm.train import load_lm_checkpoint as jax_load_lm
from rag_uq_tpu_torch.cli.evaluate import build_qa_prompt
from rag_uq_tpu_torch.llm.train import load_lm_checkpoint

FIXTURE = Path(__file__).parent / "data" / "torch_answer_fixture.json"
RUN = "runs/demo_full_r4"
LM = "models/tiny_lm_r5/tiny_lm.msgpack"
N_QUESTIONS, N_CHECKED, MAX_TOKENS, GREEDY_TOP_P = 32, 4, 100, 1e-6


def _qa_rows(n=N_QUESTIONS):
    with open(f"{RUN}/nq.jsonl") as f:
        return [json.loads(line) for line, _ in zip(f, range(n))]


def _jax_top1_contexts(questions):
    """The JAX server's top-1 passage for each question (k = 10)."""
    from rag_uq_tpu.cli.serve import QueryService
    from rag_uq_tpu.core.types import Document
    from rag_uq_tpu.embed.train import load_encoder_checkpoint
    from rag_uq_tpu.retrieval.hybrid import HybridRetriever
    from rag_uq_tpu.router.model import RetrievalRouter
    from rag_uq_tpu.router.train import RouterTrainer

    with open(f"{RUN}/corpus.jsonl") as f:
        docs = [Document.from_dict(json.loads(line)) for line in f]
    retriever = HybridRetriever(embedder=load_encoder_checkpoint(f"{RUN}/encoder/encoder.msgpack"))
    retriever.add_documents(docs)
    router = RetrievalRouter()
    RouterTrainer(router).load_checkpoint(f"{RUN}/router/best_router.msgpack")
    service = QueryService(retriever, router=router)
    try:
        hits = service.search(list(questions), 10)
    finally:
        service.close()
    return [row[0]["text"] for row in hits]


def _jax_greedy(questions, contexts):
    lm = jax_load_lm(LM)
    prompts = [jax_build_qa_prompt(q, c) for q, c in zip(questions, contexts)]
    n = len(prompts)
    texts, mean_lp, _ = lm.generate_batch_scored(
        prompts, [0.1] * n, [GREEDY_TOP_P] * n, max_tokens=MAX_TOKENS, seed=0)
    return texts, [float(x) for x in mean_lp]


def _exact_match(texts, answers):
    return float(np.mean([max(jax_exact_match(t, a) for a in ans)
                          for t, ans in zip(texts, answers)]))


def _write_fixture():
    rows = _qa_rows()
    questions = [r["question"] for r in rows]
    contexts = _jax_top1_contexts(questions)
    texts, lps = _jax_greedy(questions, contexts)
    answers = [r["answers"] for r in rows]
    FIXTURE.write_text(json.dumps({
        "source": f"{RUN}/nq.jsonl (first {N_QUESTIONS}), {RUN}/corpus.jsonl, "
                  f"{RUN}/encoder, {RUN}/router/best_router.msgpack, {LM}",
        "max_tokens": MAX_TOKENS, "top_p": GREEDY_TOP_P, "temperature": 0.1,
        "questions": questions, "answers": answers,
        "gold_doc_ids": [r["gold_doc_ids"] for r in rows],
        "contexts": contexts, "jax_greedy": texts, "jax_mean_logprob": lps,
        "exact_match": _exact_match(texts, answers),
    }, indent=1) + "\n")


def test_answer_fixture_is_current():
    if os.environ.get("RAG_UQ_TPU_TORCH_WRITE_FIXTURE"):
        _write_fixture()
    fx = json.loads(FIXTURE.read_text())
    rows = _qa_rows()
    assert fx["questions"] == [r["question"] for r in rows]
    assert fx["answers"] == [r["answers"] for r in rows]
    assert fx["exact_match"] == _exact_match(fx["jax_greedy"], fx["answers"])
    n = N_CHECKED
    texts, lps = _jax_greedy(fx["questions"][:n], fx["contexts"][:n])
    assert texts == fx["jax_greedy"][:n]
    np.testing.assert_allclose(lps, fx["jax_mean_logprob"][:n], rtol=0, atol=1e-6)


def test_port_greedy_answers_agree_with_the_fixture():
    """The card's gate, on the CPU: the port's greedy answers to the
    fixture's prompts equal JAX's on at least 28 of 32."""
    fx = json.loads(FIXTURE.read_text())
    prompts = [build_qa_prompt(q, c) for q, c in zip(fx["questions"], fx["contexts"])]
    assert prompts == [jax_build_qa_prompt(q, c) for q, c in zip(fx["questions"], fx["contexts"])]
    lm = load_lm_checkpoint(LM, device="cpu")
    n = len(prompts)
    texts, lps, _ = lm.generate_batch_scored(prompts, [0.1] * n, [GREEDY_TOP_P] * n,
                                             max_tokens=MAX_TOKENS, seed=0)
    same = sum(a == b for a, b in zip(texts, fx["jax_greedy"]))
    assert same >= 28, list(zip(texts, fx["jax_greedy"]))
    # Where the texts agree, so do the log-probabilities, to bf16 drift (up
    # to 23% of values of order 1e-4, 0.004 at -0.046, on the CPU).
    agree = [i for i in range(n) if texts[i] == fx["jax_greedy"][i]]
    np.testing.assert_allclose(np.asarray(lps)[agree],
                               np.asarray(fx["jax_mean_logprob"])[agree], rtol=0.2, atol=5e-3)

