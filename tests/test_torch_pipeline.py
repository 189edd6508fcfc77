"""The port's experiment protocol against the JAX package's, on the CPU:
``run_evaluation``, ``run_ablation_study``, ``run_calibration``, the
pipeline's pools and ``run_pipeline`` at a micro scale, the root ``Config``
and ``build_index_from_jsonl(config=...)``, ``data/verify.py``,
``data/wikipedia.py``, and the doctor, warmup, ``profile_fused`` and
quickstart entry points.

The retriever pair is ``tests/test_cli.py``'s small index (30 passages,
64-d hash embeddings) built in both packages with the JAX embedding table
carried across (``convert.embedding_table``); the router is one flax tree
loaded into both; the generator is ``MockLLM`` (deterministic), with a
scored path for the per_passage policy. Without MC sampling the results
equal the JAX ones within 1e-9 in every field but the latency and timing
ones. With MC sampling the answer embeddings' variances are float32 sums in
another order (``tests/test_torch_uq.py``: within 1e-6), so the fields that
follow from the confidences are compared within 1e-6. The pipeline's trained
weights cannot match the JAX package's (torch's random streams,
``ROADMAP.md`` C); its data, splits and pools do, exactly.
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_uq_tpu.cli import calibrate as jax_calibrate
from rag_uq_tpu.cli import evaluate as jax_evaluate
from rag_uq_tpu.cli import run_pipeline as jax_pipeline
from rag_uq_tpu.cli.build_index import build_index_from_jsonl as jax_build_index
from rag_uq_tpu.cli.build_index import verify_index as jax_verify_index
from rag_uq_tpu.core import config as jax_config
from rag_uq_tpu.core.types import Document as JaxDocument
from rag_uq_tpu.data import verify as jax_verify
from rag_uq_tpu.data.wikipedia import WikipediaDownloader as JaxDownloader
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxNgram
from rag_uq_tpu.llm.mock import MockLLM as JaxMockLLM
from rag_uq_tpu.retrieval.hybrid import HybridRetriever as JaxRetriever
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter
from rag_uq_tpu_torch.cli import calibrate, doctor, evaluate, profile_fused, run_pipeline, warmup
from rag_uq_tpu_torch.cli.build_index import build_index_from_jsonl, verify_index
from rag_uq_tpu_torch.convert import embedding_table, load_router
from rag_uq_tpu_torch.core import config
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.data import verify
from rag_uq_tpu_torch.data.loaders import create_synthetic_nq, load_qa_jsonl, write_jsonl
from rag_uq_tpu_torch.data.wikipedia import API_BASE, WikipediaDownloader
from rag_uq_tpu_torch.embed import hash_embed
from rag_uq_tpu_torch.examples import quickstart
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter

DIM, BUCKETS = 64, 4096
DENSE = dict(embedding_dim=DIM, initial_capacity=128, score_block=128)
RESPONSES = ["number 4", "topic 2", "number 8 passage", "n6", "", "number 12"]
TIMING_KEYS = {"avg_latency_ms", "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
               "router_overhead_ms", "retrieval_latency_ms", "generation_latency_ms",
               "throughput_qps", "cold_start_ms", "plots"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These paths run many small ops (TinyLM sampling at a micro size): one
    intra-op thread runs them fastest and leaves the other test workers'
    cores alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(a, b, tol, path=""):
    """Nested results equal: floats within tol, everything else exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for key in a:
            close(a[key], b[key], tol, f"{path}.{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def without_timings(results: dict) -> dict:
    """Results as JSON would hold them, less the latency and timing fields."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in TIMING_KEYS}
        return x
    return strip(json.loads(json.dumps(results)))


def _scored(base):
    """A MockLLM class of one package with the scored path, so that
    per_passage engages: mean log-probability -0.1 per character."""

    class Scored(base):
        def generate_batch_scored(self, prompts, temperatures, top_ps, max_tokens=100,
                                  seed=None):
            texts = self.generate_batch(prompts, temperatures, top_ps, max_tokens, seed)
            lp = np.asarray([-0.1 * len(t) for t in texts])
            return texts, lp, lp - 0.5

    return Scored


@pytest.fixture(scope="module")
def pair():
    """(JAX retriever, port retriever, JAX router, port router)."""
    jax_emb = JaxNgram(dim=DIM, buckets=BUCKETS)
    ours_emb = hash_embed.NgramHashEmbedder(
        dim=DIM, buckets=BUCKETS, table=embedding_table(np.asarray(jax_emb.table, np.float32)),
        device="cpu")
    ref = JaxRetriever(embedder=jax_emb, dense_config=jax_config.DenseIndexConfig(**DENSE))
    ours = HybridRetriever(embedder=ours_emb, dense_config=config.DenseIndexConfig(**DENSE),
                           device="cpu")
    docs = [(f"d{i}", f"passage about topic{i % 5} number {i}") for i in range(30)]
    ref.add_documents([JaxDocument(i, t) for i, t in docs])
    ours.add_documents([Document(i, t) for i, t in docs])
    jax_router = JaxRouter(jax_config.router_recipe_v2(), seed=3)
    router = RetrievalRouter(config.router_recipe_v2(), device="cpu")
    load_router(router, jax.tree.map(np.asarray, jax_router.params),
                jax.tree.map(np.asarray, jax_router.stats))
    jax_router.trained_num_passages = router.trained_num_passages = 12
    return ref, ours, jax_router, router


def _samples(lo, hi, step=2):
    out = []
    for i in range(lo, hi, step):
        s = {"id": f"q{i}", "question": f"topic{i % 5} number {i}",
             "answers": [f"number {i}", f"n{i}"],
             "metadata": {"slice": ("lexical", "semantic", "lookup")[i % 3]}}
        if i % 4 == 0:
            s["gold_doc_ids"] = [f"d{i}", f"d{(i + 5) % 30}"]
        out.append(s)
    return out


@pytest.fixture
def mc_table(monkeypatch):
    """MC's default answer embedder built with the JAX table."""
    made = hash_embed.NgramHashEmbedder

    def with_jax_table(dim=768, buckets=1 << 15, seed=0, max_len=256, device="cuda"):
        table = np.asarray(JaxNgram(dim=dim, buckets=buckets, seed=seed, max_len=max_len).table,
                           np.float32)
        return made(dim=dim, buckets=buckets, seed=seed, max_len=max_len,
                    table=embedding_table(table), device=device)

    monkeypatch.setattr(hash_embed, "NgramHashEmbedder", with_jax_table)


CASES = {  # name: (context policy, calibration split, router, MC samples)
    "concat": ("concat", False, True, 0),
    "concat_calibrated": ("concat", True, True, 0),
    "per_passage": ("per_passage", False, True, 0),
    "per_passage_calibrated": ("per_passage", True, True, 0),
    "no_router_calibrated": ("concat", True, False, 0),
    "mc_per_passage_calibrated": ("per_passage", True, True, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_evaluation_matches_jax(pair, mc_table, tmp_path, name):
    policy, calibrated, use_router, mc = CASES[name]
    ref, ours, jax_router, router = pair
    test, cal = _samples(0, 30), (_samples(1, 30) if calibrated else None)
    kw = dict(mc_samples=mc, calibration_samples=cal, context_policy=policy)
    a = evaluate.run_evaluation(ours, test, llm=_scored(MockLLM)(RESPONSES),
                                router=router if use_router else None,
                                output_dir=str(tmp_path / "ours"), **kw)
    b = jax_evaluate.run_evaluation(ref, test, llm=_scored(JaxMockLLM)(RESPONSES),
                                    router=jax_router if use_router else None,
                                    output_dir=str(tmp_path / "ref"), **kw)
    tol = 1e-6 if mc else 1e-9
    close(without_timings(a), without_timings(b), tol)
    assert a["protocol"]["context_policy_effective"] == policy
    assert ("confidence_scaling" in a) == calibrated
    assert "by_slice" in a["generation"] and ("router_accuracy" in a["retrieval"])
    for results in (a, b):
        assert set(results["efficiency"]["cold_start_ms"]) >= {"retrieval_ms", "total"}
    saved = [json.loads((tmp_path / side / "evaluation_results.json").read_text())
             for side in ("ours", "ref")]
    close(without_timings(saved[0]), without_timings(saved[1]), tol)
    rows = [[json.loads(line) for line in open(tmp_path / side / "predictions.jsonl")]
            for side in ("ours", "ref")]
    close(rows[0], rows[1], tol)


def test_run_ablation_study_matches_jax(pair, tmp_path):
    ref, ours, jax_router, router = pair
    test = _samples(0, 30, 1)
    a = evaluate.run_ablation_study(ours, test, router=router, output_dir=str(tmp_path / "o"))
    b = jax_evaluate.run_ablation_study(ref, test, router=jax_router,
                                        output_dir=str(tmp_path / "r"))
    close(json.loads(json.dumps(a)), json.loads(json.dumps(b)), 1e-9)
    assert set(a) == {"bm25_only", "dense_only", "fixed_hybrid", "fixed_hybrid_balanced",
                      "oracle_router", "learned_router", "headroom"}
    assert json.loads((tmp_path / "o/ablation_results.json").read_text()) == \
        json.loads(json.dumps(a))


@pytest.mark.parametrize("mode", ["length_ratio", "mc_variance"])
def test_run_calibration_matches_jax(tmp_path, mc_table, mode):
    nq = str(tmp_path / "nq.jsonl")
    create_synthetic_nq(nq, 40)
    out = {}
    for side, run, llm in (("ours", calibrate.run_calibration, MockLLM(RESPONSES)),
                           ("ref", jax_calibrate.run_calibration, JaxMockLLM(RESPONSES))):
        kw = {"device": "cpu"} if side == "ours" else {}
        out[side] = run(nq, llm_client=llm, n_calibration=20, db_path=str(tmp_path / f"{side}.db"),
                        output_path=str(tmp_path / f"{side}.json"), nonconformity_mode=mode, **kw)
    close(out["ours"], out["ref"], 1e-6 if mode == "mc_variance" else 1e-9)
    assert json.loads((tmp_path / "ours.json").read_text()).keys() == out["ours"].keys()
    reports = [calibrate.test_conformal_predictions(
                   nq, llm_client=MockLLM(RESPONSES), n_calibration=20, n_test=10,
                   db_path=str(tmp_path / "ours.db"), device="cpu"),
               jax_calibrate.test_conformal_predictions(
                   nq, llm_client=JaxMockLLM(RESPONSES), n_calibration=20, n_test=10,
                   db_path=str(tmp_path / "ref.db"))]
    close(reports[0], reports[1], 1e-6)
    assert reports[0]["n_test"] == 10


def test_root_config_defaults_match_jax():
    names = ("RouterConfig", "BM25Config", "DenseIndexConfig", "EmbedderConfig", "UQConfig",
             "EvalConfig", "ChunkConfig", "TrainConfig", "MeshConfig", "Config")
    for name in names:
        ours, ref = getattr(config, name)(), getattr(jax_config, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), name
    assert config.Config().to_dict() == jax_config.Config().to_dict()
    overrides = {"uq.alpha": 0.2, "eval.n_bins": 15, "mesh.num_corpus_shards": 4}
    assert config.Config().override(overrides).to_dict() == \
        jax_config.Config().override(overrides).to_dict()
    for bad in ({"uq": 1}, {"uq.nope": 1}):
        with pytest.raises(KeyError):
            config.Config().override(bad)
        with pytest.raises(KeyError):
            jax_config.Config().override(bad)


def test_build_index_from_jsonl_takes_the_root_config(tmp_path):
    corpus = str(tmp_path / "corpus.jsonl")
    write_jsonl(corpus, [{"id": f"d{i}", "text": f"passage about topic{i % 5} number {i}"}
                         for i in range(30)])
    kw = dict(bm25_persist_path=None, dense_persist_directory=None)
    ours = build_index_from_jsonl(
        corpus, checkpoint_path=str(tmp_path / "a.json"), device="cpu",
        config=config.Config(dense=config.DenseIndexConfig(**DENSE),
                             embedder=config.EmbedderConfig(kind="sha256", dim=DIM)), **kw)
    ref = jax_build_index(
        corpus, checkpoint_path=str(tmp_path / "b.json"),
        config=jax_config.Config(dense=jax_config.DenseIndexConfig(**DENSE),
                                 embedder=jax_config.EmbedderConfig(kind="sha256", dim=DIM)),
        **kw)
    assert len(ours) == len(ref) == 30
    assert ours.dense_index.config == config.DenseIndexConfig(**DENSE)
    queries = ["topic3 number 8", "passage about topic1"]
    a, b = verify_index(ours, queries), jax_verify_index(ref, queries)
    assert [h["doc_id"] for q in queries for h in a["queries"][q]] == \
        [h["doc_id"] for q in queries for h in b["queries"][q]]


# -- the pipeline ---------------------------------------------------------------------------


MICRO = {"articles": 40, "nq": 70, "cal": 10, "test": 5,
         "epochs": 2, "lm_steps": 5, "enc_steps": 5,
         "lm_seq_len": 256, "lm_batch": 8, "lm_ft_steps": 5,
         "lm_model": {"dim": 64, "num_layers": 2, "num_heads": 4,
                      "mlp_dim": 128, "max_prompt_len": 512, "max_total_len": 640}}


def test_run_pipeline_micro_artifacts_and_pools(tmp_path):
    work = tmp_path / "pipe"
    scales = {**MICRO, "lm_checkpoint": str(tmp_path / "absent.msgpack")}
    summary = run_pipeline.run_pipeline(workdir=str(work), scales=scales, seed=0,
                                        router_features="pool7", run_ablation=True,
                                        device="cpu")
    assert set(summary) == {"scales", "timings", "index", "encoder", "tiny_lm", "router",
                            "calibration", "evaluation", "ablation"}
    assert set(summary["timings"]) == {"data_gen_s", "encoder_train_s", "index_build_s",
                                       "lm_train_s", "router_train_s", "calibration_s",
                                       "evaluation_s", "ablation_s"}
    assert summary["index"]["total_documents"] == 40
    assert summary["encoder"]["trained"] and summary["tiny_lm"]["trained"]
    assert summary["encoder"]["router_pool_held_out"] == 55
    assert summary["evaluation"]["n_queries"] == 5
    assert "reference3_control" in summary["router"]
    for path in ("pipeline_summary.json", "corpus.jsonl", "nq.jsonl", "calibration.db",
                 "calibration_results.json", "encoder/encoder.msgpack",
                 "router/final_router.msgpack", "router_reference3/final_router.msgpack",
                 "results/evaluation_results.json", "results/predictions.jsonl",
                 "results/ablation/ablation_results.json"):
        assert (work / path).exists(), path
    assert json.loads((work / "pipeline_summary.json").read_text()) == \
        json.loads(json.dumps(summary))

    # The splits and pools are the JAX functions' rows, exactly.
    samples = load_qa_jsonl(str(work / "nq.jsonl"), limit=MICRO["nq"])
    all_rows = load_qa_jsonl(str(work / "nq.jsonl"))
    held = samples[: MICRO["cal"] + MICRO["test"]]
    fit = samples[MICRO["cal"] + MICRO["test"] :]
    for target in (0, 3, 40):
        pool = run_pipeline.build_router_pool(fit, all_rows, MICRO["nq"], target, seed=0)
        assert pool == jax_pipeline.build_router_pool(fit, all_rows, MICRO["nq"], target, seed=0)
        enc = run_pipeline.encoder_pool(all_rows, held, pool)
        assert enc == jax_pipeline.encoder_pool(all_rows, held, pool)
        assert {r["id"] for r in enc}.isdisjoint({r["id"] for r in held + pool})
    test_ids = {json.loads(line)["id"] for line in open(work / "results/predictions.jsonl")}
    assert test_ids == {r["id"] for r in samples[MICRO["cal"] : MICRO["cal"] + MICRO["test"]]}
    assert test_ids.isdisjoint({r["id"] for r in fit})


# -- data and the small entry points --------------------------------------------------------


def test_verify_matches_jax(tmp_path):
    nq = str(tmp_path / "nq.jsonl")
    create_synthetic_nq(nq, 25)
    with open(nq, "a") as f:
        f.write("not json\n\n" + json.dumps({"id": "q0", "question": "dup"}) + "\n")
    for fn in ("verify_jsonl_dataset", "verify_nq_dataset"):
        assert getattr(verify, fn)(nq) == getattr(jax_verify, fn)(nq)
    report = verify.verify_nq_dataset(nq)
    assert verify.generate_report(report, str(tmp_path / "r.txt")) == \
        jax_verify.generate_report(report)
    assert verify.file_sha256(nq) == jax_verify.file_sha256(nq)


class FakeWiki:
    """A deterministic MediaWiki API; one title fails."""

    def __init__(self):
        self.counter = 0

    def __call__(self, url, params):
        assert url == API_BASE
        if params.get("list") == "random":
            titles = [f"Article {self.counter + i}" for i in range(params["rnlimit"])]
            self.counter += params["rnlimit"]
            return {"query": {"random": [{"title": t} for t in titles]}}
        if params["titles"] == "Article 2":
            return {"query": {"pages": {"-1": {}}}}
        return {"query": {"pages": {"7": {
            "title": params["titles"], "extract": f"Text of {params['titles']}. " * 4,
            "fullurl": f"https://en.wikipedia.org/wiki/{params['titles']}"}}}}


def test_wikipedia_downloader_matches_jax(tmp_path):
    out = []
    for side, cls in (("ours", WikipediaDownloader), ("ref", JaxDownloader)):
        kw = dict(output_dir=str(tmp_path / side), rate_limit_delay=0.0, checkpoint_interval=3)
        n = cls(fetch_json=FakeWiki(), **kw).download_corpus(n_articles=7, output_file="w.jsonl")
        resumed = cls(fetch_json=FakeWiki(), **kw).download_corpus(n_articles=4,
                                                                   output_file="w.jsonl")
        out.append((n, resumed, (tmp_path / side / "w.jsonl").read_text()))
    assert out[0] == out[1] and out[0][:2] == (6, 9)  # "Article 2" is missing


def test_doctor_reports_and_creates_dirs(tmp_path):
    report = doctor.diagnose(create_dirs=True, workdir=str(tmp_path), device="cpu")
    assert report["required"]["torch"] == torch.__version__
    assert {"nvcc", "cutlass_headers", "cxx_compiler", "native_runtime", "torch_cuda",
            "optional"} <= set(report)
    for d in ("data/raw", "data/preprocessed", "models/router", "results"):
        assert (tmp_path / d).is_dir()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            doctor.diagnose()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            doctor.main(["--device", "cuda"])


def test_warmup_profile_and_quickstart_run_on_the_cpu(tmp_path, capsys):
    report = warmup.warmup(batch_sizes=(8,), corpus_rows=256, dim=32, with_llm=True,
                           device="cpu")
    assert {"native", "fused_first_b8_s", "train_step_first_s", "sampler_first_s"} <= set(report)
    out = profile_fused.run_profile(n_docs=600, dim=32, vocab=300, batch=16, block=128, reps=1,
                                    batch_sizes=(8, 16), outdir=str(tmp_path), device="cpu")
    saved = json.loads((tmp_path / "fused_breakdown.json").read_text())
    assert saved == out and out["device"] == "cpu"
    jax_keys = set(json.loads(Path("runs/profile/fused_breakdown.json").read_text()))
    assert jax_keys <= set(out)
    assert {"full_fused_scatter", "full_fused_twotier", "dense_pool", "bm25_scatter_full",
            "bm25_twotier_full", "bm25_active_row_gather", "bm25_high_tier_matmul_compact",
            "bm25_low_blocks_plus_scatter", "bm25_topk_over_BN",
            "union_merge_router_topk_tail"} <= set(out["stages_ms"])
    quickstart.main(["--device", "cpu"])
    assert "OK: end-to-end pipeline complete" in capsys.readouterr().out
