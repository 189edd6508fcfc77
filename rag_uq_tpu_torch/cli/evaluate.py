"""Answer generation for serving: four functions of ``rag_uq_tpu/cli/evaluate.py:56-129``.

``build_qa_prompt`` (the one QA prompt template, byte for byte the JAX
one), ``select_best_candidate``, ``generate_answer`` and
``generate_answer_per_passage``. The evaluation experiment itself waits
for the evaluation slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from rag_uq_tpu_torch.eval.metrics import normalize_answer


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
