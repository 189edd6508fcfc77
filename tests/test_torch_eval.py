"""The port's evaluation metrics, confidence scaling, evaluator and plots
against the JAX package's, on the CPU; and its ROUGE-L and Porter stemmer
against ``rouge-score`` and NLTK.

The same numpy inputs go through both packages. The metric functions and
``uq/scaling.py`` are numpy on both sides and agree within 1e-12 on random
labels, scores, rankings, ties and empty inputs. ``rouge_l`` and the
stemmer are compared exactly.
"""

import json
import math
import re

import numpy as np
import pytest

from rag_uq_tpu.eval import evaluator as jax_evaluator
from rag_uq_tpu.eval import metrics as jax_metrics
from rag_uq_tpu.uq import scaling as jax_scaling
from rag_uq_tpu_torch.eval import metrics, plots
from rag_uq_tpu_torch.eval.evaluator import RAGEvaluator
from rag_uq_tpu_torch.text import porter
from rag_uq_tpu_torch.uq import scaling

TOL = 1e-12
RUN = "runs/demo_full_r4"


def close(a, b, path="") -> None:
    """Nested results equal: floats within TOL, everything else exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


# -- ROUGE-L and the Porter stemmer ---------------------------------------------------------


def _words(text: str):
    return re.sub(r"[^a-z0-9]+", " ", text.lower()).split()


def _vocabulary():
    """Every distinct token of the demo corpus, its questions, answers and
    contexts, and the repository's README and SURVEY."""
    words = set()
    with open(f"{RUN}/corpus.jsonl") as f:
        for line in f:
            words.update(_words(json.loads(line)["text"]))
    with open(f"{RUN}/nq.jsonl") as f:
        for line in f:
            row = json.loads(line)
            for text in [row["question"], row.get("context", ""), *row.get("answers", [])]:
                words.update(_words(text))
    for name in ("README.md", "SURVEY.md"):
        with open(name) as f:
            words.update(_words(f.read()))
    return sorted(words)


def test_porter_stemmer_equals_nltk():
    nltk_porter = pytest.importorskip("nltk.stem.porter")
    stemmer = nltk_porter.PorterStemmer()
    words = _vocabulary() + ["skies", "dying", "yyy", "syzygy", "agreed", "hopping", "fizzed",
                             "conformabli", "radicalli", "vietnamization", "archaeology",
                             "generously", "ies", "cries", "ties", "Running", "SKY"]
    assert len(words) > 20_000
    differ = [w for w in words if porter.stem(w) != stemmer.stem(w)]
    assert differ == []


def _rouge_pairs():
    hand = [("The cats were running home", "cat ran home"),
            ("George Orwell wrote it in 1949", "In 1949 Orwell wrote it"),
            ("Paris is the capital", "paris"), ("", "x"), ("  ", "  "), ("x", ""),
            ("É café naïve — 1,857!", "cafe 1857"), ("a b c", "c b a d")]
    with open(f"{RUN}/nq.jsonl") as f:
        rows = [json.loads(line) for line in f]
    rng = np.random.default_rng(0)
    drawn = []
    for i, j in rng.integers(0, len(rows), size=(150, 2)):
        answer = (rows[i].get("answers") or [""])[0]
        drawn.append((answer, rows[j].get("context", "")[:400]))
        drawn.append((rows[i].get("context", "")[:200], answer))
    return hand, drawn


def test_rouge_l_equals_the_jax_function_with_rouge_score():
    pytest.importorskip("rouge_score")
    pytest.importorskip("nltk")
    assert jax_metrics._get_rouge() is not None  # rouge-score is live on the JAX side
    hand, drawn = _rouge_pairs()
    assert [round(metrics.rouge_l(p, r), 6) for p, r in hand[:3]] == [0.5, 0.545455, 0.4]
    for pred, ref in hand + drawn:
        assert metrics.rouge_l(pred, ref) == jax_metrics.rouge_l(pred, ref), (pred, ref)


# -- metric functions -----------------------------------------------------------------------


def _rankings(seed: int, n: int):
    """Random retrieved lists (with repeats, empties) and gold sets."""
    rng = np.random.default_rng(seed)
    retrieved = [[f"d{x}" for x in rng.integers(0, 12, size=rng.integers(0, 12))]
                 for _ in range(n)]
    gold = [[f"d{x}" for x in rng.integers(0, 12, size=rng.integers(0, 4))] for _ in range(n)]
    return retrieved, gold


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrieval_metrics_match_jax(seed):
    retrieved, gold = _rankings(seed, 40)
    rng = np.random.default_rng(seed + 10)
    for r, g in zip(retrieved, gold):
        for k in (0, 1, 3, 10, 20):
            assert metrics.recall_at_k(r, g, k) == jax_metrics.recall_at_k(r, g, k)
            assert metrics.precision_at_k(r, g, k) == jax_metrics.precision_at_k(r, g, k)
        assert metrics.reciprocal_rank(r, g) == jax_metrics.reciprocal_rank(r, g)
        rels = {d: float(rng.integers(0, 4)) for d in g}
        for k in (1, 5, 10):
            close(metrics.ndcg_at_k(r, rels, k), jax_metrics.ndcg_at_k(r, rels, k))
    grades = rng.integers(0, 4, size=15).astype(float).tolist()
    for k in (0, 1, 5, 15):
        close(metrics.dcg(grades, k), jax_metrics.dcg(grades, k))
    router = rng.integers(0, 2, size=40).tolist()
    oracle = rng.integers(-1, 2, size=40).tolist()
    relevance = [{d: float(rng.integers(0, 3)) for d in g} for g in gold]
    for kw in ({}, {"router_decisions": router, "oracle_decisions": oracle},
               {"relevance_scores": relevance, "k_values": (1, 2, 7)},
               {"router_decisions": [0] * 40, "oracle_decisions": [-1] * 40}):
        close(metrics.evaluate_retrieval(retrieved, gold, **kw).to_dict(),
              jax_metrics.evaluate_retrieval(retrieved, gold, **kw).to_dict())


ANSWERS = ["Paris", "paris.", "The Eiffel tower!", "", "1,857", "cat ran home", "a b c d",
           "George Orwell", "In 1949", "lyon"]


@pytest.mark.parametrize("seed", [0, 1])
def test_generation_metrics_and_labels_match_jax(seed):
    rng = np.random.default_rng(seed)
    preds = [ANSWERS[i] for i in rng.integers(0, len(ANSWERS), size=30)]
    refs = [ANSWERS[i] for i in rng.integers(0, len(ANSWERS), size=30)]
    aliases = [[ANSWERS[i] for i in rng.integers(0, len(ANSWERS), size=rng.integers(0, 4))]
               for _ in range(30)]
    close(metrics.evaluate_generation(preds, refs).to_dict(),
          jax_metrics.evaluate_generation(preds, refs).to_dict())
    assert metrics.correctness_labels(preds, refs) == jax_metrics.correctness_labels(preds, refs)
    assert metrics.correctness_labels_multi(preds, aliases) == \
        jax_metrics.correctness_labels_multi(preds, aliases)
    assert [metrics.best_reference(p, a) for p, a in zip(preds, aliases)] == \
        [jax_metrics.best_reference(p, a) for p, a in zip(preds, aliases)]


def _confidences(seed: int, n: int):
    rng = np.random.default_rng(seed)
    conf = rng.random(n)
    conf[: n // 4] = 0.5  # ties on a bin edge
    conf[n // 4 : n // 3] = 1.0
    conf[n // 3 : n // 3 + 2] = 0.0  # outside every (lo, hi] bin
    return conf, rng.integers(0, 2, size=n)


@pytest.mark.parametrize("seed,n,bins", [(0, 50, 10), (1, 7, 5), (2, 200, 15)])
def test_calibration_metrics_match_jax(seed, n, bins):
    conf, correct = _confidences(seed, n)
    close(metrics.evaluate_calibration(conf, correct, bins).to_dict(),
          jax_metrics.evaluate_calibration(conf, correct, bins).to_dict())
    close(metrics.expected_calibration_error(conf, correct, bins),
          jax_metrics.expected_calibration_error(conf, correct, bins))
    close(metrics.brier_score(conf, correct), jax_metrics.brier_score(conf, correct))


def test_empty_inputs_match_jax():
    close(metrics.expected_calibration_error(np.zeros(0), np.zeros(0)),
          jax_metrics.expected_calibration_error(np.zeros(0), np.zeros(0)))
    assert metrics.recall_at_k(["a"], [], 5) == jax_metrics.recall_at_k(["a"], [], 5) == 0.0
    assert metrics.reciprocal_rank([], ["a"]) == jax_metrics.reciprocal_rank([], ["a"]) == 0.0
    assert metrics.ndcg_at_k([], {}, 10) == jax_metrics.ndcg_at_k([], {}, 10) == 0.0
    assert metrics.best_reference("x", []) == jax_metrics.best_reference("x", []) == ""


@pytest.mark.parametrize("with_parts", [False, True])
def test_efficiency_and_bootstrap_match_jax(with_parts):
    rng = np.random.default_rng(3)
    lat = rng.random(37) * 0.2
    parts = {"router_times": (rng.random(37) * 0.01).tolist(),
             "retrieval_times": (lat * 0.3).tolist(),
             "generation_times": (lat * 0.7).tolist()} if with_parts else {}
    close(metrics.evaluate_efficiency(lat, **parts).to_dict(),
          jax_metrics.evaluate_efficiency(lat, **parts).to_dict())
    data = rng.integers(0, 2, size=25).tolist()
    close(metrics.bootstrap_metric(data, np.mean, 200, 0.9, rng=np.random.default_rng(5)),
          jax_metrics.bootstrap_metric(data, np.mean, 200, 0.9, rng=np.random.default_rng(5)))


# -- confidence scaling ---------------------------------------------------------------------


def _calibration_split(seed: int, n: int, kind: str):
    rng = np.random.default_rng(seed)
    scores = rng.random(n)
    if kind == "ties":
        scores = np.round(scores * 4) / 4
    y = (rng.random(n) < scores).astype(float)
    if kind == "one_sided":
        y[:] = 1.0
    return scores, y


@pytest.mark.parametrize("kind", ["random", "ties", "one_sided", "empty"])
def test_platt_and_isotonic_match_jax(kind):
    n = 0 if kind == "empty" else 120
    s, y = _calibration_split(7, n, kind)
    probe = np.linspace(-0.2, 1.2, 29)
    a, b = scaling.fit_platt(s, y)
    ja, jb = jax_scaling.fit_platt(s, y)
    close((a, b), (ja, jb))
    close(scaling.apply_platt(probe, a, b), jax_scaling.apply_platt(probe, ja, jb))
    xs, gs = scaling.fit_isotonic(s, y)
    jxs, jgs = jax_scaling.fit_isotonic(s, y)
    close(xs, jxs)
    close(gs, jgs)
    close(scaling.apply_isotonic(probe, xs, gs), jax_scaling.apply_isotonic(probe, jxs, jgs))


@pytest.mark.parametrize("kind", ["random", "constant_feature", "empty"])
def test_logistic_matches_jax(kind):
    rng = np.random.default_rng(11)
    n = 0 if kind == "empty" else 90
    x = rng.normal(size=(n, 5))
    if kind == "constant_feature":
        x[:, 2] = 1.0
    y = (x[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(float)
    w, jw = scaling.fit_logistic(x, y), jax_scaling.fit_logistic(x, y)
    close(w, jw)
    probe = rng.normal(size=(13, 5))
    close(scaling.apply_logistic(probe, w), jax_scaling.apply_logistic(probe, jw))


# -- evaluator and plots --------------------------------------------------------------------


@pytest.mark.parametrize("router", [False, True])
def test_full_evaluation_matches_jax(tmp_path, router):
    retrieved, gold = _rankings(4, 20)
    rng = np.random.default_rng(4)
    preds = [ANSWERS[i] for i in rng.integers(0, len(ANSWERS), size=20)]
    refs = [ANSWERS[i] for i in rng.integers(0, len(ANSWERS), size=20)]
    kw = dict(retrieved_ids=retrieved, gold_ids=gold, predictions=preds, references=refs,
              confidences=rng.random(20).tolist(), latencies=(rng.random(20) * 0.1).tolist())
    if router:
        kw.update(router_weights=rng.random(20).tolist(),
                  router_decisions=rng.integers(0, 2, size=20).tolist(),
                  oracle_decisions=rng.integers(-1, 2, size=20).tolist())
    ours = RAGEvaluator(output_dir=str(tmp_path / "ours")).run_full_evaluation(**kw)
    ref = jax_evaluator.RAGEvaluator(output_dir=str(tmp_path / "ref")).run_full_evaluation(**kw)
    plot_paths = ours.pop("plots"), ref.pop("plots")
    close(json.loads(json.dumps(ours)), json.loads(json.dumps(ref)))
    saved = json.loads((tmp_path / "ours/evaluation_results.json").read_text())
    assert saved.keys() == ours.keys() | {"plots"}
    for ours_path, ref_path in zip(*(p.values() for p in plot_paths)):
        assert (ours_path is None) == (ref_path is None) == (not router and ref_path is None)
        if ours_path is not None:
            assert ours_path.startswith(str(tmp_path / "ours"))
    evaluator = RAGEvaluator(output_dir=str(tmp_path / "boot"))
    close(evaluator.bootstrap_metric([1, 0, 1, 1], np.mean, 50)[0], 0.75)


def test_plots_write_pngs_or_return_none_without_matplotlib(tmp_path, monkeypatch):
    calibration = metrics.evaluate_calibration([0.2, 0.7, 0.9], [0, 1, 1])
    pytest.importorskip("matplotlib")
    paths = [plots.plot_reliability_diagram(calibration, output_dir=str(tmp_path)),
             plots.plot_routing_analysis([0.1, 0.2], [0.3, 0.1], [0.2, 0.8], [1, 0],
                                         output_dir=str(tmp_path)),
             plots.plot_routing_analysis([0.1], [0.3], [0.2], None, output_dir=str(tmp_path),
                                         save_path=str(tmp_path / "r2.png")),
             plots.plot_training_curves([3.0, 2.0], [3.5, 2.5], output_dir=str(tmp_path))]
    assert [p.rsplit("/", 1)[-1] for p in paths] == [
        "reliability_diagram.png", "routing_analysis.png", "r2.png", "training_curves.png"]
    assert all((tmp_path / p.rsplit("/", 1)[-1]).stat().st_size > 0 for p in paths)
    # Where matplotlib cannot be imported, each plot logs and returns None.
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert plots.plot_reliability_diagram(calibration, output_dir=str(tmp_path)) is None
    assert plots.plot_routing_analysis([0.1], [0.2], [0.3], output_dir=str(tmp_path)) is None
    assert plots.plot_training_curves([1.0], output_dir=str(tmp_path)) is None
