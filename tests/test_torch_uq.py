"""The port's UQ stack (MC sampling, conformal, hybrid) and answer metrics
against the JAX package's, on the CPU.

Both sides use the same generator (``MockLLM``, deterministic), the same
numpy seed and the same answer-embedding table (the JAX
``NgramHashEmbedder``'s, carried across with ``convert.embedding_table``),
so every result is compared exactly, except: embedding variances within
1e-6 (f32 sums of the same bf16 rows in another order), and the conformal
threshold and p-value within 1e-6 (float32 on both sides). The JAX
``rouge_l`` is compared with ``rouge-score`` switched off, the form the
port implements (``eval/metrics.py``).
"""

import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rag_uq_tpu.eval.metrics as jax_metrics
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxNgram
from rag_uq_tpu.llm.mock import MockLLM as JaxMockLLM
from rag_uq_tpu.uq.conformal import ConformalRAG as JaxConformal
from rag_uq_tpu.uq.conformal import conformal_p_value_device as jax_p_value
from rag_uq_tpu.uq.conformal import conformal_threshold_device as jax_threshold
from rag_uq_tpu.uq.hybrid import HybridConfidence as JaxHybrid
from rag_uq_tpu.uq.mc import MCDropoutConfidence as JaxMC
from rag_uq_tpu_torch.convert import embedding_table
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder
from rag_uq_tpu_torch.eval import metrics
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.uq.conformal import (
    ConformalRAG,
    conformal_p_value_device,
    conformal_threshold_device,
)
from rag_uq_tpu_torch.uq.hybrid import HybridConfidence
from rag_uq_tpu_torch.uq.mc import ConfidenceResult, MCDropoutConfidence

RESPONSES = ["Paris", "paris.", "Lyon", "", "The city of Paris", "  ", "Paris"]
CONTEXTS = ["Paris is the capital of France.", "Lyon lies on the Rhone.", "Nothing here."]
QUESTIONS = ["What is the capital?", "Where is Lyon?", "Unknown?"]
ANSWERS = ["Paris", "on the Rhone", "none"]


@pytest.fixture(scope="module")
def embedders():
    jax_emb = JaxNgram(dim=384)
    table = embedding_table(np.asarray(jax_emb.table, dtype=np.float32))
    return jax_emb, NgramHashEmbedder(dim=384, table=table, device="cpu")


class ScoredMock(MockLLM):
    """A MockLLM with the scored path: mean log-probability -0.1 * length."""

    def generate_batch_scored(self, prompts, temperatures, top_ps, max_tokens=100, seed=None):
        texts = self.generate_batch(prompts, temperatures, top_ps, max_tokens, seed)
        lp = np.asarray([-0.1 * len(t) for t in texts])
        return texts, lp, lp


class JaxScoredMock(JaxMockLLM):
    generate_batch_scored = ScoredMock.generate_batch_scored


def _same_result(ours: ConfidenceResult, ref) -> None:
    assert ours.answers == ref.answers
    assert ours.consensus_answer == ref.consensus_answer
    assert ours.lexical_diversity == ref.lexical_diversity
    assert ours.uncertainty_score == pytest.approx(ref.uncertainty_score, abs=1e-6)
    assert ours.confidence == pytest.approx(ref.confidence, abs=1e-6)
    if ref.embedding_variance is None:
        assert ours.embedding_variance is None
    else:
        assert ours.embedding_variance == pytest.approx(ref.embedding_variance, abs=1e-6)
    assert set(ours.metadata) == set(ref.metadata)
    for key, value in ref.metadata.items():
        assert ours.metadata[key] == pytest.approx(value, abs=1e-6), key


@pytest.mark.parametrize("scored", [False, True])
def test_mc_confidence_matches_jax(embedders, scored):
    jax_emb, emb = embedders
    llm, jllm = (ScoredMock(RESPONSES), JaxScoredMock(RESPONSES)) if scored else \
        (MockLLM(RESPONSES), JaxMockLLM(RESPONSES))
    ours = MCDropoutConfidence(llm, n_samples=5, embedder=emb, seed=3, device="cpu")
    ref = JaxMC(jllm, n_samples=5, embedder=jax_emb, seed=3)
    # One example, then a batch (3 x 5 = 15 prompts: one JAX call), then one
    # more example: the numpy stream stays in step throughout.
    _same_result(ours.get_confidence_interval("Answer.", CONTEXTS[0], QUESTIONS[0]),
                 ref.get_confidence_interval("Answer.", CONTEXTS[0], QUESTIONS[0]))
    for a, b in zip(ours.get_confidence_batch("Answer.", CONTEXTS, QUESTIONS),
                    ref.get_confidence_batch("Answer.", CONTEXTS, QUESTIONS)):
        _same_result(a, b)
    _same_result(ours.get_confidence_interval("Answer.", CONTEXTS[1], QUESTIONS[1]),
                 ref.get_confidence_interval("Answer.", CONTEXTS[1], QUESTIONS[1]))
    assert llm.call_count == jllm.call_count
    empty = MCDropoutConfidence(MockLLM([""]), n_samples=3, embedder=emb, seed=0, device="cpu")
    res = empty.get_confidence_interval("Answer.", "c", "q")
    assert res.confidence == 0.0 and res.answers == [] and "error" in res.metadata


def test_answer_metrics_match_jax(monkeypatch):
    monkeypatch.setattr(jax_metrics, "_get_rouge", lambda: None)
    pairs = [("Paris", "paris"), ("The Eiffel tower!", "eiffel tower"), ("", "x"),
             ("a b c", "c b a d"), ("1,857", "1857"), ("Lyon", "Paris"), ("  ", "  ")]
    for pred, ref in pairs:
        assert metrics.normalize_answer(pred) == jax_metrics.normalize_answer(pred)
        assert metrics.exact_match(pred, ref) == jax_metrics.exact_match(pred, ref)
        assert metrics.token_f1(pred, ref) == jax_metrics.token_f1(pred, ref)
        assert metrics.rouge_l(pred, ref) == jax_metrics.rouge_l(pred, ref)


@pytest.mark.parametrize("n,alpha", [(1, 0.1), (9, 0.1), (10, 0.1), (500, 0.1), (37, 0.05),
                                     (500, 0.0), (20, 0.5)])
def test_threshold_and_p_value_match_jax(n, alpha):
    rng = np.random.default_rng(n)
    scores = rng.random(n).astype(np.float32)
    scores[: n // 4] = 0.25  # ties
    ours = conformal_threshold_device(torch.from_numpy(scores), alpha)
    ref = jax_threshold(jnp.asarray(scores), jnp.float32(alpha))
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), abs=1e-6)
    for est in (0.0, 0.25, 0.5, float(scores.max()), 1.5):
        assert float(conformal_p_value_device(torch.from_numpy(scores), est)) == \
            pytest.approx(float(jax_p_value(jnp.asarray(scores), jnp.float32(est))), abs=1e-6)


def test_calibrate_resume_and_predict_match_jax(tmp_path):
    ours_db, ref_db = str(tmp_path / "ours.db"), str(tmp_path / "ref.db")
    ours = ConformalRAG(MockLLM(RESPONSES), calibration_db_path=ours_db, alpha=0.2, device="cpu")
    ref = JaxConformal(JaxMockLLM(RESPONSES), calibration_db_path=ref_db, alpha=0.2)
    assert ours.get_conformal_threshold() == ref.get_conformal_threshold() == 1.0
    empty = ours.predict_with_coverage(QUESTIONS[0], CONTEXTS[0])
    assert empty.p_value == 0.5 and not empty.is_reliable
    ref.predict_with_coverage(QUESTIONS[0], CONTEXTS[0])
    assert ours.get_calibration_stats() == ref.get_calibration_stats() == {"empty": True}
    # Two calibrations with an overlap: the second resumes past stored rows.
    for lo, hi in ((0, 2), (1, 3)):
        a = ours.calibrate(QUESTIONS[lo:hi], CONTEXTS[lo:hi], ANSWERS[lo:hi])
        b = ref.calibrate(QUESTIONS[lo:hi], CONTEXTS[lo:hi], ANSWERS[lo:hi])
        assert a == pytest.approx(b)
    assert a["skipped"] == 1 and a["total_calibrated"] == 3
    assert ours.calibration_scores == ref.calibration_scores
    stored = []
    for path in (ours_db, ref_db):  # the same rows on disk, readable by either
        with sqlite3.connect(path) as conn:
            stored.append(conn.execute("SELECT query_hash, predicted_answer, nonconformity_score "
                                       "FROM calibration_scores ORDER BY id").fetchall())
    assert stored[0] == stored[1] and len(stored[0]) == 3
    reopened = ConformalRAG(MockLLM(RESPONSES), calibration_db_path=ref_db, alpha=0.2,
                            device="cpu")
    assert reopened.calibration_scores == ref.calibration_scores
    assert ours.get_calibration_stats() == pytest.approx(ref.get_calibration_stats())
    for q, c in zip(QUESTIONS, CONTEXTS):
        a, b = ours.predict_with_coverage(q, c), ref.predict_with_coverage(q, c)
        assert (a.prediction, a.is_reliable, a.coverage_alpha) == \
            (b.prediction, b.is_reliable, b.coverage_alpha)
        assert a.confidence == pytest.approx(b.confidence)
        assert a.p_value == pytest.approx(b.p_value, abs=1e-6)
        assert a.metadata == pytest.approx(b.metadata)


def test_mc_variance_mode_matches_jax(tmp_path, embedders, monkeypatch):
    jax_emb, emb = embedders
    llm, jllm = MockLLM(RESPONSES), JaxMockLLM(RESPONSES)
    kw = dict(alpha=0.3, nonconformity_mode="mc_variance", n_mc_samples=4)
    ours = ConformalRAG(llm, calibration_db_path=str(tmp_path / "a.db"), device="cpu", **kw)
    ref = JaxConformal(jllm, calibration_db_path=str(tmp_path / "b.db"), **kw)
    # The hash-seeded estimator embeds with its default NgramHashEmbedder,
    # whose seeded table differs between the packages: give both the JAX one.
    import rag_uq_tpu.uq.mc as jax_mc_mod
    import rag_uq_tpu_torch.uq.mc as mc_mod

    for mod, table_emb in ((mc_mod, emb), (jax_mc_mod, jax_emb)):
        init = mod.MCDropoutConfidence.__init__

        def with_table(self, llm_client, n_samples=10, embedder=None, _init=init,
                       _emb=table_emb, **rest):
            _init(self, llm_client, n_samples, embedder or _emb, **rest)

        monkeypatch.setattr(mod.MCDropoutConfidence, "__init__", with_table)
    assert ours.calibrate(QUESTIONS, CONTEXTS, ANSWERS) == \
        pytest.approx(ref.calibrate(QUESTIONS, CONTEXTS, ANSWERS))
    assert np.allclose(ours.calibration_scores, ref.calibration_scores, atol=1e-6)
    for q, c in zip(QUESTIONS, CONTEXTS):
        a, b = ours.predict_with_coverage(q, c), ref.predict_with_coverage(q, c)
        assert a.prediction == b.prediction and a.is_reliable == b.is_reliable
        assert a.p_value == pytest.approx(b.p_value, abs=1e-6)
        assert a.confidence == pytest.approx(b.confidence, abs=1e-6)
    # A caller's batched estimator scores the calibration chunk in one call.
    batched = ConformalRAG(MockLLM(RESPONSES), calibration_db_path=str(tmp_path / "c.db"),
                           device="cpu", mc=MCDropoutConfidence(
                               MockLLM(RESPONSES), n_samples=3, embedder=emb, seed=1,
                               device="cpu"), **kw)
    jbatched = JaxConformal(JaxMockLLM(RESPONSES), calibration_db_path=str(tmp_path / "d.db"),
                            mc=JaxMC(JaxMockLLM(RESPONSES), n_samples=3, embedder=jax_emb,
                                     seed=1), **kw)
    assert batched.calibrate(QUESTIONS, CONTEXTS, ANSWERS) == \
        pytest.approx(jbatched.calibrate(QUESTIONS, CONTEXTS, ANSWERS))
    assert np.allclose(batched.calibration_scores, jbatched.calibration_scores, atol=1e-6)
    with pytest.raises(ValueError):
        ConformalRAG(llm, calibration_db_path=str(tmp_path / "e.db"), nonconformity_mode="x",
                     device="cpu")


def test_hybrid_confidence_matches_jax(tmp_path, embedders):
    jax_emb, emb = embedders
    for alpha in (0.1, 0.9):
        ours = HybridConfidence(MockLLM(RESPONSES), mc_samples=4, conformal_alpha=alpha,
                                calibration_db_path=str(tmp_path / f"o{alpha}.db"),
                                embedder=emb, device="cpu")
        ref = JaxHybrid(JaxMockLLM(RESPONSES), mc_samples=4, conformal_alpha=alpha,
                        calibration_db_path=str(tmp_path / f"r{alpha}.db"), embedder=jax_emb)
        # The MC sampler is unseeded in both packages: seed both alike.
        ours.mc._rng, ref.mc._rng = np.random.default_rng(5), np.random.default_rng(5)
        ours.conformal.calibrate(QUESTIONS, CONTEXTS, ANSWERS)
        ref.conformal.calibrate(QUESTIONS, CONTEXTS, ANSWERS)
        a = ours.estimate_uncertainty("Answer.", CONTEXTS[0], QUESTIONS[0])
        b = ref.estimate_uncertainty("Answer.", CONTEXTS[0], QUESTIONS[0])
        assert set(a) == set(b)
        for key in ("answer", "answer_source", "is_reliable", "mc_answers"):
            assert a[key] == b[key], key
        for key in ("combined_confidence", "mc_confidence", "mc_uncertainty",
                    "mc_embedding_variance", "conformal_confidence", "conformal_p_value"):
            assert a[key] == pytest.approx(b[key], abs=1e-6), key
