"""TinyLM extractor pretraining: the counterpart of ``rag_uq_tpu/cli/train_lm.py``.

A single pipeline's QA set is small enough to memorize, so this experiment
trains the extraction skill on a multi-world QA stream: the questions of
many ``data/synth_wiki.py`` worlds, whose answers are spans of the given
context, with distractor passages mixed in (``--curriculum``: 1-3 of them,
half same-kind confusables, packed so the gold passage is never cut).
Batches come from a per-step seeded generator and the state is saved
every 1,000 steps to ``train_state.msgpack``, so a restart resumes the run
that never stopped. Evaluation is exact match on a world the training
stream never saw (seed 0), gold-only, with random distractors and with
same-kind distractors, sampled with the port's TinyLM. The checkpoint
``tiny_lm.msgpack`` loads in either package.

Run: ``python3 -m rag_uq_tpu_torch.cli.train_lm [--worlds N --steps S ...]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.llm.tiny_lm import TinyLMConfig
from rag_uq_tpu_torch.llm.train import (
    QA_HEADERS,
    LMTrainConfig,
    TinyLMTrainer,
    build_qa_prompt,
    encode_qa_examples,
)
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

logger = logging.getLogger(__name__)


def multi_world_qa(
    n_worlds: int, articles_per_world: int, seed0: int = 1,
    hard_pools: bool = False,
    alias_q: int = 0,
    lookup_q: int = 0,
    inverse_q: int = 0,
    question_style: str = "v1",
) -> tuple:
    """QA samples + distractor texts pooled from several generated worlds.

    With `hard_pools`, also returns a per-sample list of CONFUSABLE
    passages: same-world same-entity-kind articles (identical sentence
    templates, different names/values) excluding the gold — the
    distribution retrieved-passage distractors actually come from. Pool
    lists are shared per (world, kind), so memory stays O(corpus).
    Returns (samples, distractors[, per_sample_hard_pools]).
    """
    from rag_uq_tpu_torch.data.synth_wiki import generate_world

    samples, distractors, pools = [], [], []
    for seed in range(seed0, seed0 + n_worlds):
        # alias_q / lookup_q expose the extractor to the pipeline's full
        # question-style mix: alias (semantic) questions read like base
        # ones with unfamiliar names, but archive-lookup questions invert
        # the extraction direction (the answer is the entity NAME picked
        # by a value conjunction) — a style zero-shot extraction from
        # base-only pretraining has never seen.
        w = generate_world(
            articles_per_world, seed=seed,
            alias_questions_per_entity=alias_q,
            lookup_questions_per_entity=lookup_q,
            # Inverse rows flip the extraction direction (answer = entity
            # name found next to the named value); v2 widens the phrasing
            # registers — both measured blind spots of the hand-written
            # out-of-family split (BASELINE.md r4).
            inverse_questions_per_entity=inverse_q,
            question_style=question_style,
        )
        rows = w.qa_rows()
        samples += rows
        distractors += [a["text"] for a in w.articles[:500]]
        if hard_pools:
            by_kind: dict = {}
            for a in w.articles:
                by_kind.setdefault(a["metadata"]["kind"], []).append(a["text"])
            gold_kind = {
                a["id"]: a["metadata"]["kind"] for a in w.articles
            }
            for r in rows:
                kind = gold_kind[r["gold_doc_ids"][0]]
                pools.append(by_kind.get(kind, []))
    if hard_pools:
        return samples, distractors, pools
    return samples, distractors


def eval_extraction(
    lm, test_samples: Sequence[Dict], max_tokens: int = 40, batch: int = 25,
    distractor_texts: Optional[Sequence[str]] = None, n_distractors: int = 2,
    hard_pools: Optional[Sequence[Sequence[str]]] = None,
    seed: int = 11,
    gold_first: bool = False,
) -> Dict[str, float]:
    """EM + answer-substring rate on unseen data.

    Default: gold-only contexts. With `distractor_texts`, each context is
    the gold passage shuffled among `n_distractors` random passages — the
    distribution the model actually sees at evaluation time (top-3
    retrieved passages), and the number that predicts pipeline EM. With
    `hard_pools` (per-sample confusable-passage lists), distractors come
    from the sample's pool instead — the hardest, most retrieval-like
    setting. `gold_first` pins the gold passage to the front (the
    recall@1-hit serving case) instead of shuffling it.
    """
    rng = np.random.default_rng(seed)
    contexts = []
    for i, s in enumerate(test_samples):
        if not distractor_texts and hard_pools is None:
            contexts.append(s["context"])
            continue
        parts = [s["context"]]
        for _ in range(n_distractors):
            if hard_pools is not None and hard_pools[i]:
                pool = hard_pools[i]
            elif distractor_texts:
                pool = distractor_texts
            else:
                continue  # no distractor source for this sample
            # Pools include the gold article (shared per world/kind);
            # reject it at draw time so a "hard distractor" is never a
            # gold duplicate that makes the example easier.
            for _attempt in range(4):
                cand = pool[int(rng.integers(len(pool)))]
                if cand != s["context"]:
                    parts.append(cand)
                    break
        if gold_first:
            rest = parts[1:]
            rng.shuffle(rest)
            parts = [parts[0]] + rest
        else:
            rng.shuffle(parts)
        contexts.append(" ".join(parts))

    prompts = [
        build_qa_prompt(s["question"], c, QA_HEADERS[0])
        for s, c in zip(test_samples, contexts)
    ]
    outs = []
    for i in range(0, len(prompts), batch):
        chunk = prompts[i : i + batch]
        outs += lm.generate_batch(
            chunk, [0.1] * len(chunk), [0.9] * len(chunk),
            max_tokens=max_tokens, seed=3,
        )
    em = float(np.mean([
        o.strip().lower() == s["answers"][0].strip().lower()
        for o, s in zip(outs, test_samples)
    ]))
    contains = float(np.mean([
        s["answers"][0].lower() in o.lower() for o, s in zip(outs, test_samples)
    ]))
    return {"exact_match": em, "answer_substring_rate": contains,
            "n_test": len(test_samples)}


def train_extractor(
    output_dir: str = "models/tiny_lm",
    n_worlds: int = 15,
    articles_per_world: int = 2000,
    steps: int = 12000,
    batch_size: int = 64,
    seq_len: int = 512,
    dim: int = 384,
    num_layers: int = 6,
    learning_rate: float = 5e-4,
    seed: int = 0,
    eval_n: int = 200,
    init_from: Optional[str] = None,
    curriculum: bool = False,
    alias_q: int = 0,
    lookup_q: int = 0,
    inverse_q: int = 0,
    question_style: str = "v1",
    oversample_lookup: int = 1,
    gold_first_prob: float = 0.0,
    device: DeviceLike = "cuda",
) -> Dict:
    """Pretrain (or, with `curriculum`, continue training) the extractor.

    `curriculum=True` is the round-3 distractor curriculum (VERDICT r2
    next #4): every example carries 1..3 distractors (never gold-only),
    half drawn from the sample's same-kind confusable pool, packed only
    while the prompt fits `seq_len` so the gold passage is never
    truncated into label noise.
    """
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    hard_pools = None
    if curriculum:
        samples, distractors, hard_pools = multi_world_qa(
            n_worlds, articles_per_world, hard_pools=True,
            alias_q=alias_q, lookup_q=lookup_q, inverse_q=inverse_q,
            question_style=question_style,
        )
    else:
        samples, distractors = multi_world_qa(
            n_worlds, articles_per_world, alias_q=alias_q, lookup_q=lookup_q,
            inverse_q=inverse_q, question_style=question_style,
        )
    logger.info("%d training QAs from %d worlds in %.0fs",
                len(samples), n_worlds, time.time() - t0)
    if oversample_lookup > 1:
        # Archive-lookup rows invert the extraction direction (pick the
        # entity NAME that satisfies a value conjunction) and sit at ~8%
        # of the natural mix — too rare for the hardest split to converge
        # (lookup-hard EM 0.38 at the natural rate). Replicating them
        # raises their per-batch sampling rate; pools replicate alongside
        # so curriculum distractors stay per-sample confusables.
        extra = [i for i, s in enumerate(samples)
                 if s["metadata"]["slice"] == "lookup"]
        for _ in range(oversample_lookup - 1):
            samples += [samples[i] for i in extra]
            if hard_pools is not None:
                hard_pools += [hard_pools[i] for i in extra]
        logger.info("oversampled %d lookup rows x%d -> %d training QAs",
                    len(extra), oversample_lookup, len(samples))

    model_cfg = TinyLMConfig(
        dim=dim, num_layers=num_layers, num_heads=max(dim // 64, 1),
        mlp_dim=4 * dim, max_prompt_len=1024, max_total_len=1280,
    )
    trainer = TinyLMTrainer(
        model_cfg,
        LMTrainConfig(
            seq_len=seq_len, batch_size=batch_size, total_steps=steps,
            warmup_steps=max(steps // 50, 10), learning_rate=learning_rate,
            seed=seed,
        ),
        device=device,
    )
    # Resumable loop: batches are drawn with a per-step seeded rng so a
    # restart at step s reproduces the run that never stopped (the relayed
    # TPU can wedge; long runs must survive process restarts).
    if curriculum:
        data, masks = encode_qa_examples(
            samples, seq_len, seed=seed, distractor_texts=distractors,
            min_distractors=1, max_distractors=3,
            hard_distractors=hard_pools, hard_fraction=0.5, fit_budget=True,
            gold_first_prob=gold_first_prob,
        )
    else:
        data, masks = encode_qa_examples(
            samples, seq_len, seed=seed, distractor_texts=distractors
        )
    logger.info("Encoded %d QA rows of %d bytes", data.shape[0], seq_len)
    state_path = str(out / "train_state.msgpack")
    start = trainer.restore_state(state_path)
    if start == 0 and init_from and Path(init_from).exists():
        # Warm start (continued pretraining at a new seq_len/schedule):
        # params only — the optimizer state and LR schedule start fresh.
        trainer.load_params(load_flax_checkpoint(init_from))
        logger.info("Warm-started params from %s", init_from)
    t0 = time.time()
    for step in range(start, steps):
        rng = np.random.default_rng((seed << 20) + step)
        idx = rng.integers(0, data.shape[0], size=batch_size)
        loss = trainer.train_step(data[idx], masks[idx])
        if step % 200 == 0:
            logger.info("step %d/%d loss %.4f", step, steps, loss)
        if step and step % 1000 == 0:
            trainer.save_state(state_path)
    trainer.save_state(state_path)
    losses = trainer.losses
    train_secs = time.time() - t0

    # Held-out world: seed 0 is never in the training stream (seed0=1).
    from rag_uq_tpu_torch.data.synth_wiki import generate_world

    test_world = generate_world(
        max(eval_n, 100), seed=0,
        alias_questions_per_entity=alias_q,
        lookup_questions_per_entity=lookup_q,
        inverse_questions_per_entity=inverse_q,
        question_style=question_style,
    )
    lm = trainer.export_sampler()
    # Base rows first so the headline EMs stay comparable across rounds;
    # lookup rows get their own eval below when enabled.
    all_rows = test_world.qa_rows()
    test_rows = [
        r for r in all_rows if r["metadata"]["slice"] == "lexical"
    ][:eval_n]
    metrics = eval_extraction(lm, test_rows)
    metrics_distract = eval_extraction(
        lm, test_rows,
        distractor_texts=[r["text"] for r in test_world.corpus_rows()],
    )
    # Hard (same-kind confusable) distractors: the retrieval-like setting.
    by_kind: dict = {}
    for a in test_world.articles:
        by_kind.setdefault(a["metadata"]["kind"], []).append(a["text"])
    kind_of = {a["id"]: a["metadata"]["kind"] for a in test_world.articles}
    test_pools = [
        by_kind[kind_of[r["gold_doc_ids"][0]]] for r in test_rows
    ]
    metrics_hard = eval_extraction(
        lm, test_rows,
        distractor_texts=[r["text"] for r in test_world.corpus_rows()],
        hard_pools=test_pools,
    )
    metrics_lookup = None
    if lookup_q > 0:
        lookup_rows = [
            r for r in all_rows if r["metadata"]["slice"] == "lookup"
        ][:eval_n]
        if lookup_rows:
            lk_pools = [
                by_kind[kind_of[r["gold_doc_ids"][0]]] for r in lookup_rows
            ]
            metrics_lookup = eval_extraction(
                lm, lookup_rows,
                distractor_texts=[r["text"] for r in test_world.corpus_rows()],
                hard_pools=lk_pools,
            )
    metrics_inverse = None
    if inverse_q > 0:
        inverse_rows = [
            r for r in all_rows if r["metadata"]["slice"] == "inverse"
        ][:eval_n]
        if inverse_rows:
            inv_pools = [
                by_kind[kind_of[r["gold_doc_ids"][0]]] for r in inverse_rows
            ]
            metrics_inverse = eval_extraction(
                lm, inverse_rows,
                distractor_texts=[r["text"] for r in test_world.corpus_rows()],
                hard_pools=inv_pools,
            )
    # Alias (semantic-slice) splits: the question names an alias that
    # appears in NO passage, so with same-kind confusables the gold is
    # content-indistinguishable — shuffled vs gold-first separates the
    # content skill from the serving position prior (r4 extraction gap).
    metrics_alias = metrics_alias_first = None
    if alias_q > 0:
        alias_rows = [
            r for r in all_rows if r["metadata"]["slice"] == "semantic"
        ][:eval_n]
        if alias_rows:
            al_pools = [
                by_kind[kind_of[r["gold_doc_ids"][0]]] for r in alias_rows
            ]
            corpus_texts = [r["text"] for r in test_world.corpus_rows()]
            metrics_alias = eval_extraction(
                lm, alias_rows, distractor_texts=corpus_texts,
                hard_pools=al_pools,
            )
            metrics_alias_first = eval_extraction(
                lm, alias_rows, distractor_texts=corpus_texts,
                hard_pools=al_pools, gold_first=True,
            )

    ckpt = str(out / "tiny_lm.msgpack")
    trainer.save_checkpoint(ckpt)
    results = {
        "n_train_qas": len(samples),
        "steps": len(losses),
        "first_loss": losses[0],
        "final_loss": float(np.mean(losses[-50:])),
        "train_seconds": round(train_secs, 1),
        "unseen_world_eval": metrics,
        "unseen_world_eval_distractors": metrics_distract,
        "unseen_world_eval_hard_distractors": metrics_hard,
        "unseen_world_eval_lookup_hard": metrics_lookup,
        "unseen_world_eval_inverse_hard": metrics_inverse,
        "unseen_world_eval_alias_hard": metrics_alias,
        "unseen_world_eval_alias_hard_gold_first": metrics_alias_first,
        "gold_first_prob": gold_first_prob,
        "question_style": question_style,
        "curriculum": curriculum,
        "checkpoint": ckpt,
        "model_config": vars(model_cfg),
    }
    with open(out / "lm_results.json", "w") as f:
        json.dump(results, f, indent=2)
    logger.info("Extractor results: %s", json.dumps(results, indent=2))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Pretrain the TinyLM extractor")
    parser.add_argument("--output-dir", default="models/tiny_lm")
    parser.add_argument("--worlds", type=int, default=15)
    parser.add_argument("--articles-per-world", type=int, default=2000)
    parser.add_argument("--steps", type=int, default=12000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--dim", type=int, default=384)
    parser.add_argument("--layers", type=int, default=6)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--init-from", default=None,
        help="warm-start params from an existing tiny_lm.msgpack "
        "(continued pretraining, e.g. at a longer --seq-len)",
    )
    parser.add_argument("--curriculum", action="store_true",
                        help="hard-distractor curriculum (1-3 distractors, "
                        "half same-kind confusables, budget-fit packing)")
    parser.add_argument("--alias-q", type=int, default=0,
                        help="alias (semantic-slice) questions per entity "
                        "in each training world")
    parser.add_argument("--lookup-q", type=int, default=0,
                        help="archive-lookup questions per animal entity "
                        "in each training world")
    parser.add_argument("--inverse-q", type=int, default=0,
                        help="inverse-direction questions (answer = entity "
                        "name) per person/city entity in each training world")
    parser.add_argument("--question-style", default="v1",
                        choices=("v1", "v2"),
                        help="v2 widens question phrasing registers and asks "
                        "the four never-asked article attributes "
                        "(data/synth_wiki.py)")
    parser.add_argument("--oversample-lookup", type=int, default=1,
                        help="replicate lookup-slice training rows this "
                        "many times (their natural rate is too low for "
                        "the hardest split to converge)")
    parser.add_argument("--gold-first-prob", type=float, default=0.0,
                        help="probability the curriculum places the gold "
                        "passage FIRST (the serving-time retrieval-order "
                        "prior; ~recall@1 of the deployment)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(train_extractor(
        output_dir=args.output_dir, n_worlds=args.worlds,
        articles_per_world=args.articles_per_world, steps=args.steps,
        batch_size=args.batch_size, dim=args.dim, num_layers=args.layers,
        learning_rate=args.lr, seq_len=args.seq_len, seed=args.seed,
        init_from=args.init_from, curriculum=args.curriculum,
        alias_q=args.alias_q, lookup_q=args.lookup_q,
        inverse_q=args.inverse_q, question_style=args.question_style,
        oversample_lookup=args.oversample_lookup,
        gold_first_prob=args.gold_first_prob, device=args.device,
    ), indent=2))


if __name__ == "__main__":
    main()
