"""Full experiment pipeline runner: the counterpart of ``rag_uq_tpu/cli/run_pipeline.py``.

Capability parity with the reference's 6-step shell pipeline
(scripts/run_experiment.sh:17-33): corpus prep -> QA prep -> index build ->
router training -> conformal calibration -> evaluation, implemented as one
Python entry point so a single process reuses the device indices across
stages — plus two steps the reference delegates to external pretrained
services and therefore doesn't have: encoder contrastive training (its
`nomic-embed-text` equivalent) and TinyLM QA fine-tuning (its `llama3.2`
equivalent). With no real corpus supplied, data comes from a seeded
synthetic-wikipedia world (data/synth_wiki.py; this environment has no
network — real corpora plug in via --corpus/--nq-path).

Scale mapping: the reference's --quick downloads 100 Wikipedia *articles*
(hundreds of words each -> thousands of passages); our synthetic articles
are single-passage, so quick generates 1,500 of them to land in the same
passage-count regime.

Every step runs on ``device`` through the port's trainers, index and UQ
stack; a pretrained TinyLM is read with ``utils/checkpoint.py`` (flax
msgpack without flax). The summary (``pipeline_summary.json``) and every
artifact are the JAX pipeline's. The random streams are torch's, so the
trained weights differ from a JAX run with the same seed; the data, splits
and pools do not.

Run: ``python3 -m rag_uq_tpu_torch.cli.run_pipeline --workdir runs/p
[--quick] [--router-features pool7] [--ablation] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from rag_uq_tpu_torch.cli.build_index import build_index_from_jsonl, verify_index
from rag_uq_tpu_torch.cli.calibrate import run_calibration
from rag_uq_tpu_torch.cli.evaluate import run_ablation_study, run_evaluation
from rag_uq_tpu_torch.cli.train_router import prepare_training_data, train_router
from rag_uq_tpu_torch.core.config import (
    Config, EmbedderConfig, RouterConfig, TrainConfig, router_recipe_v2,
)
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.data.loaders import load_qa_jsonl, write_jsonl
from rag_uq_tpu_torch.data.synth_wiki import generate_world, write_world
from rag_uq_tpu_torch.embed.encoder import EncoderConfig
from rag_uq_tpu_torch.embed.train import (
    ContrastiveTrainer, EncoderTrainConfig, augment_registers,
)
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.llm.tiny_lm import TinyLMConfig
from rag_uq_tpu_torch.llm.train import LMTrainConfig, TinyLMTrainer
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.train import load_router_checkpoint
from rag_uq_tpu_torch.uq.conformal import ConformalRAG
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

logger = logging.getLogger(__name__)


def _qa_slice(row: dict) -> str:
    return (row.get("metadata") or {}).get("slice", "unk")


def build_router_pool(
    fit_samples: list,
    all_rows: list,
    nq_cap: int,
    balance_target: int = 0,
    seed: int = 0,
) -> list:
    """Router training pool: the fit tail, optionally family-balanced.

    With ``balance_target > 0``, the rare routing families (inverse,
    lookup — the ones whose per-query best tower OPPOSES the majority
    families') are topped up to that many queries from rows beyond the
    ``nq_cap`` experiment window, so the gate sees enough of them to learn
    the policy (the JAX package's scripts/router_recipe_v2_probe_r5.py).
    Rows [0, nq_cap) hold the cal/test windows, so extras drawn past the
    cap can never leak into evaluation.
    """
    pool = list(fit_samples)
    if balance_target > 0:
        fams = Counter(_qa_slice(r) for r in pool)
        extra_pool = all_rows[nq_cap:]
        for family in ("inverse", "lookup"):
            need = max(0, balance_target - fams[family])
            pool.extend(
                [r for r in extra_pool if _qa_slice(r) == family][:need])
        np.random.default_rng(seed).shuffle(pool)
    return pool


def encoder_pool(
    all_rows: list, held_samples: list, router_samples: list
) -> list:
    """Contrastive-training pool for the encoder: every QA row except

    (a) the held-out cal/test questions,
    (b) lookup rows sharing a (habitat, diet, lifespan) conjunction entity
        with a held-out or router-pool lookup question — a paraphrase of
        the same conjunction would let the encoder memorize that exact
        mapping (a no-op at lookup_questions=1, correct above it), and
    (c) **the router training pool itself**. The encoder memorizes its
        training questions verbatim (measured: dense gold RR ~1.0 on
        encoder-seen rows vs 0.10-0.20 held out, regardless of entity
        exposure — runs/demo_full_r4/results/router_gate_diag2.json), so
        a router fit on encoder-seen queries learns its gate from
        memorization-inflated dense features and misroutes at test time
        (lookup MRR 0.339 routed vs 0.794 bm25). Holding the router pool
        out of the encoder keeps the fit-time feature distribution equal
        to the test-time one.
    """
    held_ids = {s["id"] for s in held_samples if "id" in s}
    router_ids = {s["id"] for s in router_samples if "id" in s}
    guard_entities = {
        (s.get("metadata") or {}).get("entity")
        for s in list(held_samples) + list(router_samples)
        if _qa_slice(s) == "lookup"
    }
    return [
        s for s in all_rows
        if s.get("id") not in held_ids
        and s.get("id") not in router_ids
        and not (
            _qa_slice(s) == "lookup"
            and (s.get("metadata") or {}).get("entity") in guard_entities
        )
    ]


def run_pipeline(
    workdir: str = "runs/pipeline",
    quick: bool = False,
    corpus_path: Optional[str] = None,
    nq_path: Optional[str] = None,
    llm=None,
    seed: int = 0,
    train_lm: bool = True,
    train_encoder: bool = True,
    scales: Optional[dict] = None,
    alias_questions: int = 0,
    lookup_questions: int = 0,
    inverse_questions: int = 0,
    run_ablation: bool = False,
    question_style: Optional[str] = None,  # "v1" | "v2"
    router_features: Optional[str] = None,  # e.g. "pool7"
    context_policy: Optional[str] = None,  # "concat" | "per_passage"
    router_balance_target: int = 0,  # top up inverse/lookup to this many
    device: DeviceLike = "cuda",
) -> dict:
    scales = scales or (
        {"articles": 1500, "nq": 1500, "cal": 100, "test": 50, "epochs": 10,
         "lm_steps": 1500, "enc_steps": 800}
        if quick
        else {"articles": 5000, "nq": 3000, "cal": 500, "test": 200,
              "epochs": 50, "lm_steps": 4000, "enc_steps": 2000}
    )
    # Protocol knobs: explicit parameters win; scales-dict keys kept as a
    # compatibility fallback.
    question_style = question_style or scales.get("question_style", "v1")
    router_features = router_features or scales.get("router_features")
    context_policy = context_policy or scales.get("context_policy", "concat")
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    timings = {}

    # Step 1-2: corpus + QA data.
    if corpus_path is None or nq_path is None:
        t0 = time.time()
        # alias_questions > 0 adds the paraphrase-stress semantic split
        # (entity aliases that appear in no article; data/synth_wiki.py).
        world = generate_world(
            scales["articles"], seed=seed,
            alias_questions_per_entity=alias_questions,
            lookup_questions_per_entity=lookup_questions,
            inverse_questions_per_entity=inverse_questions,
            # "v2" widens question phrasing registers and asks the four
            # never-asked article attributes (synth_wiki.py v2 comment);
            # default "v1" keeps earlier rounds' worlds byte-identical.
            question_style=question_style,
        )
        gen_corpus = str(work / "corpus.jsonl")
        gen_nq = str(work / "nq.jsonl")
        # Shuffle QAs so the calibration/test slices span entity kinds.
        rng = np.random.default_rng(seed)
        qa_rows = world.qa_rows()
        rng.shuffle(qa_rows)
        write_jsonl(gen_nq, qa_rows)
        write_world(world, gen_corpus)
        corpus_path = corpus_path or gen_corpus
        nq_path = nq_path or gen_nq
        timings["data_gen_s"] = round(time.time() - t0, 1)

    samples = load_qa_jsonl(nq_path, limit=scales["nq"])
    cal_samples = samples[: scales["cal"]]
    test_samples = samples[scales["cal"] : scales["cal"] + scales["test"]]
    # Training pool for the learned components excludes the held-out test
    # slice (the reference trains its router on all samples including test —
    # a leak we don't copy).
    fit_samples = samples[scales["cal"] + scales["test"] :]
    all_rows = load_qa_jsonl(nq_path)
    # The router pool is fixed BEFORE encoder training so it can be held
    # out of the encoder's contrastive pool (see encoder_pool).
    router_pool = build_router_pool(
        fit_samples, all_rows, nq_cap=scales["nq"],
        balance_target=router_balance_target
        or int(scales.get("router_balance_target", 0)),
        seed=seed,
    )

    # Step 2.5: encoder contrastive training (the framework's own
    # nomic-embed-text).
    #
    # Training pool: the FULL QA file minus the cal/test questions AND minus
    # the router fit pool (encoder_pool above). The reference's embedder
    # (nomic-embed-text) is pretrained on far more text than the experiment's
    # own sample budget; our analog is every world QA pair that is not a
    # held-out evaluation question or a router-fit question. The width
    # matters for the paraphrase-stress semantic split: an entity alias
    # occurs in NO article, so the encoder can only bridge alias->entity if
    # some *other* question using that alias is in its training pool (with
    # alias_questions>=2 each entity has spares). In the JAX package's runs,
    # the 2,300-row tail gave only 17/93 semantic test entities alias
    # coverage and dense semantic recall@10 0.086; the full pool covers
    # 91/93. The router-pool holdout removes ~8% of rows and is what keeps
    # the gate's features honest.
    embedder_cfg = EmbedderConfig()
    encoder_info = {"trained": False}
    if train_encoder and fit_samples:
        # Pool rules (incl. the router-pool holdout and the lookup
        # conjunction guard) live in encoder_pool's docstring. Alias
        # (semantic) rows of held-out entities are NOT excluded: learning
        # an alias from other questions is the capability that slice
        # measures, memorizing a conjunction (or a router-fit question)
        # is not.
        enc_pool = encoder_pool(
            all_rows, cal_samples + test_samples, router_pool)
        # Register augmentation (embed/train.py::augment_registers): N
        # surface-register variants per question, paired with the source
        # question's positive passage, so the encoder learns content words
        # rather than the template scaffolding.
        enc_queries = [s["question"] for s in enc_pool]
        enc_passages = [s.get("context", "") for s in enc_pool]
        n_aug = 0
        if scales.get("enc_augment", 0) > 0:
            aug_q, aug_src = augment_registers(
                enc_queries, seed=seed,
                variants_per_query=int(scales["enc_augment"]),
            )
            enc_queries = enc_queries + aug_q
            enc_passages = enc_passages + [enc_passages[i] for i in aug_src]
            n_aug = len(aug_q)
        t0 = time.time()
        trainer = ContrastiveTrainer(
            config=EncoderTrainConfig(
                total_steps=scales["enc_steps"],
                batch_size=min(256, max(len(enc_pool) // 2, 8)),
                seed=seed,
            ),
            encoder_config=EncoderConfig(
                dim=256, num_layers=2, num_heads=8, mlp_dim=1024,
                max_seq_len=64, vocab_buckets=1 << 14,
            ),
            device=device,
        )
        losses = trainer.fit(enc_queries, enc_passages, log_every=200)
        enc_ckpt = str(work / "encoder/encoder.msgpack")
        trainer.save_checkpoint(enc_ckpt)
        embedder_cfg = EmbedderConfig(kind="encoder", checkpoint_path=enc_ckpt)
        encoder_info = {
            "trained": True,
            "steps": len(losses),
            "final_loss": losses[-1],
            "train_pool": len(enc_pool),
            "router_pool_held_out": len(router_pool),
            "augmented_pairs": n_aug,
            "checkpoint": enc_ckpt,
        }
        timings["encoder_train_s"] = round(time.time() - t0, 1)

    # Step 3: index build (streaming, checkpointed) with the trained encoder.
    t0 = time.time()
    retriever = build_index_from_jsonl(
        corpus_path,
        checkpoint_path=str(work / "index_checkpoint.json"),
        bm25_persist_path=None,
        dense_persist_directory=None,
        config=Config(embedder=embedder_cfg),
        device=device,
    )
    index_report = verify_index(retriever)
    timings["index_build_s"] = round(time.time() - t0, 1)

    # Step 3.5: TinyLM generator (the framework's own llama3.2). Preferred
    # path: the pretrained EXTRACTOR checkpoint (cli/train_lm.py —
    # copy-from-context learned on a large multi-world QA stream where
    # memorization is impossible), used ZERO-SHOT by default: measured by
    # the JAX package on the quick pipeline, 300 fine-tune steps on the
    # local 1350-QA slice DEGRADE held-out EM (0.34 vs 0.46 zero-shot) by
    # drifting the general selection ability toward the small corpus. Set
    # scales["lm_ft_steps"] > 0 to opt into fine-tuning (real domain
    # shift); fallback with no checkpoint: train from scratch on the
    # pipeline QAs alone (memorizes train answers, near-zero held-out EM).
    lm_info = {"trained": False, "llm": type(llm).__name__ if llm else None}
    lm_ckpt = scales.get("lm_checkpoint", "models/tiny_lm/tiny_lm.msgpack")
    if llm is None and train_lm and fit_samples:
        t0 = time.time()
        pretrained = Path(lm_ckpt).exists()
        if pretrained:
            with open(str(lm_ckpt) + ".json") as f:
                ckpt_meta = json.load(f)
            model_cfg = TinyLMConfig(**ckpt_meta["model_config"])
            ft_steps = scales.get("lm_ft_steps", 0)
            lm_trainer = TinyLMTrainer(
                model_cfg,
                LMTrainConfig(
                    seq_len=scales.get(
                        "lm_seq_len", ckpt_meta["model_config"]["max_prompt_len"]
                    ),
                    batch_size=scales.get("lm_batch", 32),
                    total_steps=max(ft_steps, 1),
                    warmup_steps=min(50, max(ft_steps // 10, 1)),
                    learning_rate=1e-4,
                    seed=seed,
                ),
                device=device,
            )
            lm_trainer.load_params(load_flax_checkpoint(str(lm_ckpt)))
        else:
            # scales["lm_model"] overrides the scratch model dims (tests
            # use a tiny decoder — the default 4x256 model is too slow to
            # train AND sample from on a 1-core CPU host).
            model_cfg = (
                TinyLMConfig(**scales["lm_model"])
                if "lm_model" in scales else None
            )
            lm_trainer = TinyLMTrainer(
                model_cfg,
                config=LMTrainConfig(
                    seq_len=scales.get("lm_seq_len", 768),
                    batch_size=scales.get("lm_batch", 32),
                    total_steps=scales["lm_steps"],
                    warmup_steps=min(100, max(scales["lm_steps"] // 10, 1)),
                    seed=seed,
                ),
                device=device,
            )
        if pretrained and scales.get("lm_ft_steps", 0) == 0:
            lm_losses = []  # zero-shot: the pretrained extractor as-is
        else:
            lm_losses = lm_trainer.fit_qa(
                fit_samples,
                distractor_texts=[
                    retriever.documents.texts[i]
                    for i in range(len(retriever.documents))
                ],
            )
        llm = lm_trainer.export_sampler(seed=seed)
        lm_info = {
            "trained": True,
            "pretrained_checkpoint": lm_ckpt if pretrained else None,
            "steps": len(lm_losses),
            "first_loss": lm_losses[0] if lm_losses else None,
            "final_loss": lm_losses[-1] if lm_losses else None,
        }
        timings["lm_train_s"] = round(time.time() - t0, 1)
    elif llm is None:
        llm = MockLLM(
            ["Paris.", "George Orwell wrote it.", "In 1949.", "It is a concept."]
        )

    # Step 4: router training on retrieval scores + pseudo-labels.
    t0 = time.time()
    router_pool = router_pool or samples
    split = int(0.9 * len(router_pool))
    train = prepare_training_data(retriever, router_pool[:split])
    val = prepare_training_data(retriever, router_pool[split:])
    train_cfg = TrainConfig(
        num_epochs=scales["epochs"], checkpoint_dir=str(work / "router")
    )
    # feature_set knob (default "reference3" = reference parity). "pool7"
    # adds pool-context features so rare-term needle queries route to the
    # sparse tower (router/model.py docstring); "v2" selects the full
    # recipe (pool7 + max-norm fuse + binary gate + decision loss,
    # core/config.router_recipe_v2) — the configuration that first made the
    # learned gate beat the best fixed arm in the JAX package's runs. The
    # checkpoint records the architecture, so
    # downstream loads need no flag.
    router_cfg = None
    if router_features == "v2":
        router_cfg = router_recipe_v2()
    elif router_features:
        router_cfg = RouterConfig(feature_set=router_features)
    router_results = train_router(
        train, val, train_config=train_cfg, router_config=router_cfg,
        output_dir=str(work / "router"), device=device,
    )
    if router_cfg is not None:
        # Control: a reference3-architecture router on the SAME training
        # arrays, so the feature set's contribution is attributable (same
        # isolation discipline as the fixed_hybrid_balanced arm). Router
        # training is seconds next to the surrounding stages.
        ref3_cfg = TrainConfig(
            num_epochs=scales["epochs"],
            checkpoint_dir=str(work / "router_reference3"),
        )
        router_results["reference3_control"] = train_router(
            train, val, train_config=ref3_cfg,
            output_dir=str(work / "router_reference3"), device=device,
        )
    timings["router_train_s"] = round(time.time() - t0, 1)

    # Step 5: conformal calibration.
    # UQ mode: "mc_variance" (default) uses one exchangeable score
    # function at calibration and inference, so the conformal guarantee
    # holds AND the reported confidence tracks answer consistency;
    # "length_ratio" is the reference-parity heuristic (uq/conformal.py).
    uq_mode = scales.get("uq_mode", "mc_variance")
    t0 = time.time()
    cal_results = run_calibration(
        nq_path,
        llm_client=llm,
        n_calibration=scales["cal"],
        db_path=str(work / "calibration.db"),
        output_path=str(work / "calibration_results.json"),
        nonconformity_mode=uq_mode,
        device=device,
    )
    timings["calibration_s"] = round(time.time() - t0, 1)

    # Step 6: evaluation with the trained router + real UQ.
    t0 = time.time()
    router = RetrievalRouter(device=device)
    load_router_checkpoint(router, str(work / "router/final_router.msgpack"))
    eval_mc = None
    if uq_mode == "mc_variance":
        eval_mc = MCDropoutConfidence(llm, n_samples=8, seed=0, device=device)
    conformal = ConformalRAG(llm, calibration_db_path=str(work / "calibration.db"),
                             nonconformity_mode=uq_mode, mc=eval_mc, device=device)
    # mc_samples>0 switches _predict_batch to the MC confidence path, which
    # is what collects the per-query feature vectors (MC disagreement,
    # agreement rate, length stats, retrieval margin) the multi-feature
    # logistic calibrator needs. Without it the
    # evaluation silently falls back to single-score Platt/isotonic only.
    eval_results = run_evaluation(
        retriever,
        test_samples,
        llm=llm,
        router=router,
        conformal=conformal,
        mc_samples=8 if uq_mode == "mc_variance" else 0,
        calibration_samples=cal_samples,
        output_dir=str(work / "results"),
        # "per_passage" closes the concat-distractor extraction gap measured
        # in runs/demo_full_r3/results/extraction_decomposition.json.
        context_policy=context_policy,
    )
    timings["evaluation_s"] = round(time.time() - t0, 1)

    ablation_results = None
    if run_ablation:
        t0 = time.time()
        ablation_results = run_ablation_study(
            retriever, test_samples, llm=llm, router=router,
            output_dir=str(work / "results" / "ablation"),
        )
        timings["ablation_s"] = round(time.time() - t0, 1)

    summary = {
        "scales": scales,
        "timings": timings,
        "index": {k: index_report[k] for k in
                  ("total_documents", "bm25_documents", "dense_documents")},
        "encoder": encoder_info,
        "tiny_lm": lm_info,
        "router": router_results,
        "calibration": {k: cal_results[k] for k in
                        ("total_calibrated", "mean_nonconformity")},
        "evaluation": eval_results["summary"],
    }
    if ablation_results is not None:
        summary["ablation"] = ablation_results
    with open(work / "pipeline_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("Pipeline complete: %s", work / "pipeline_summary.json")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Run the full experiment pipeline")
    parser.add_argument("--workdir", default="runs/pipeline")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--corpus", default=None)
    parser.add_argument("--nq-path", default=None)
    parser.add_argument("--mock-llm", action="store_true",
                        help="skip TinyLM training, use the canned MockLLM")
    parser.add_argument("--no-encoder", action="store_true",
                        help="skip encoder training (lexical hash embedder)")
    parser.add_argument("--semantic", type=int, default=0, metavar="N",
                        help="add N alias (paraphrase-stress) questions per "
                        "entity to the generated world")
    parser.add_argument("--lookup", type=int, default=0, metavar="N",
                        help="add up to N conjunctive archive-lookup "
                        "questions per animal entity (bm25-favoring slice)")
    parser.add_argument("--inverse", type=int, default=0, metavar="N",
                        help="add up to N inverse-direction questions per "
                        "person/city entity (question names a unique "
                        "attribute value, answer is the entity name)")
    parser.add_argument("--ablation", action="store_true",
                        help="run the 4-arm retrieval ablation on the test "
                        "split (per-slice when --semantic is on)")
    parser.add_argument("--question-style", default=None,
                        choices=("v1", "v2"),
                        help="question template table for the generated "
                        "world (v2 widens phrasing registers)")
    parser.add_argument("--router-features", default=None,
                        choices=("reference3", "pool7", "v2"),
                        help="router gate feature set; pool7 adds "
                        "pool-context features + a reference3 control run; "
                        "v2 selects the full recipe "
                        "(core/config.router_recipe_v2)")
    parser.add_argument("--router-balance-target", type=int, default=0,
                        help="top up the inverse/lookup router-training "
                        "families to this many queries from rows beyond "
                        "the nq cap (0 = fit tail only)")
    parser.add_argument("--context-policy", default=None,
                        choices=("concat", "per_passage"),
                        help="evaluation context policy (cli/evaluate.py)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    summary = run_pipeline(
        workdir=args.workdir, quick=args.quick,
        corpus_path=args.corpus, nq_path=args.nq_path,
        llm=MockLLM() if args.mock_llm else None,
        train_lm=not args.mock_llm,
        train_encoder=not args.no_encoder,
        seed=args.seed,
        alias_questions=args.semantic,
        lookup_questions=args.lookup,
        inverse_questions=args.inverse,
        run_ablation=args.ablation,
        question_style=args.question_style,
        router_features=args.router_features,
        context_policy=args.context_policy,
        router_balance_target=args.router_balance_target,
        device=args.device,
    )
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    main()
