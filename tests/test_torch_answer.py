"""``/answer`` of the port's HTTP front end against the JAX server's, and the
answer helpers of ``cli/evaluate.py``, on the CPU.

Both servers serve the same index. With ``MockLLM`` (plain, and with a
scored path so the per-passage policy selects) the responses are equal.
With TinyLM the generators are carried across (a small float32 JAX init
through ``convert.load_tiny_lm``) and decoded greedily on both sides (the
served temperature 0.1 / top-p 0.9 samples from streams that differ
between the packages), so the answers are equal too. Last, ``main`` with
the JAX server's defaults loads the shipped encoder and TinyLM, and its
``/answer`` returns the text the JAX server returns on the same saved
index.
"""

import json
import os
import tempfile
import threading
import urllib.request

import jax
import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from rag_uq_tpu.cli.serve import QueryService as JaxQueryService  # noqa: E402
from rag_uq_tpu.cli.serve import serve_http as jax_serve_http  # noqa: E402
from rag_uq_tpu.embed.train import load_encoder_checkpoint as jax_load_encoder  # noqa: E402
from rag_uq_tpu.llm.mock import MockLLM as JaxMockLLM  # noqa: E402
from rag_uq_tpu.llm.tiny_lm import TinyLM as JaxTinyLM  # noqa: E402
from rag_uq_tpu.llm.tiny_lm import TinyLMConfig as JaxTinyLMConfig  # noqa: E402
from rag_uq_tpu.llm.train import load_lm_checkpoint as jax_load_lm  # noqa: E402
from rag_uq_tpu.retrieval.hybrid import HybridRetriever as JaxRetriever  # noqa: E402
from rag_uq_tpu_torch.cli import evaluate  # noqa: E402
from rag_uq_tpu_torch.cli import serve as serve_mod  # noqa: E402
from rag_uq_tpu_torch.cli.serve import QueryService, serve_http  # noqa: E402
from rag_uq_tpu_torch.convert import load_tiny_lm  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.train import load_encoder_checkpoint  # noqa: E402
from rag_uq_tpu_torch.llm.mock import MockLLM  # noqa: E402
from rag_uq_tpu_torch.llm.tiny_lm import TinyLM, TinyLMConfig  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402

from tests.test_torch_serving import make_corpus, make_queries, retriever_pair  # noqa: E402
from tests.test_torch_uq import JaxScoredMock, ScoredMock  # noqa: E402

SMALL_LM = dict(dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_prompt_len=256,
                max_total_len=320, dtype="float32")


def _call(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


class Greedy:
    """A generator with top-p forced to 1e-6 (only the most likely token)."""

    def __init__(self, lm, max_tokens=12):
        self.lm, self.max_tokens = lm, max_tokens

    def generate(self, prompt, temperature=0.1, top_p=0.9, max_tokens=100, seed=None):
        return self.lm.generate(prompt, temperature, 1e-6, self.max_tokens, seed)

    def generate_batch_scored(self, prompts, temperatures, top_ps, max_tokens=100, seed=None):
        return self.lm.generate_batch_scored(prompts, temperatures, [1e-6] * len(prompts),
                                             self.max_tokens, seed)


def _answers(ref_service, ours_service, jllm, llm, requests, policy="concat"):
    jserver = jax_serve_http(ref_service, llm=jllm, port=0, context_policy=policy)
    tserver = serve_http(ours_service, llm=llm, port=0, context_policy=policy)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (jserver, tserver)]
    for t in threads:
        t.start()
    try:
        return [(_call(tserver.server_address[1], "/answer", r),
                 _call(jserver.server_address[1], "/answer", r)) for r in requests]
    finally:
        for s in (jserver, tserver):
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)


def _same(ours, ref):
    assert ours["answer"] == ref["answer"]
    assert ours["confidence"] == pytest.approx(ref["confidence"])
    assert [h["doc_id"] for h in ours["passages"]] == [h["doc_id"] for h in ref["passages"]]


@pytest.fixture(scope="module")
def services():
    docs = make_corpus(60, seed=29)
    ref, ours = retriever_pair(docs)
    jsvc, tsvc = JaxQueryService(ref, tick_ms=1.0), QueryService(ours, tick_ms=1.0)
    yield docs, jsvc, tsvc
    jsvc.close()
    tsvc.close()


@pytest.mark.parametrize("policy", ["concat", "per_passage"])
def test_answer_with_mock_llm_matches_jax(services, policy):
    docs, jsvc, tsvc = services
    queries = make_queries(docs, n=3)[:3]
    requests = [{"question": q, "k": 4} for q in queries] + [
        {"question": queries[0], "context_passages": 2},
        {"question": queries[1], "context_policy": "per_passage" if policy == "concat" else "concat"},
        {"question": "unknownterm"}]
    for llm, jllm in ((MockLLM(["Paris", "", "w1 w2"]), JaxMockLLM(["Paris", "", "w1 w2"])),
                      (ScoredMock(["w1", "", "w3 w9 w1"]), JaxScoredMock(["w1", "", "w3 w9 w1"]))):
        for ours, ref in _answers(jsvc, tsvc, jllm, llm, requests, policy):
            _same(ours, ref)
        assert llm.call_count == jllm.call_count > 0


@pytest.mark.parametrize("policy", ["concat", "per_passage"])
def test_answer_with_small_tiny_lm_matches_jax(services, policy):
    docs, jsvc, tsvc = services
    jlm = JaxTinyLM(JaxTinyLMConfig(**SMALL_LM), seed=4)
    lm = load_tiny_lm(TinyLM(TinyLMConfig(**SMALL_LM), device="cpu"),
                      jax.tree.map(np.asarray, jlm.params))
    requests = [{"question": q, "k": 3} for q in make_queries(docs, n=2)[:2]]
    results = _answers(jsvc, tsvc, Greedy(jlm), Greedy(lm), requests, policy)
    for ours, ref in results:
        _same(ours, ref)
    assert any(ours["answer"] for ours, _ in results)  # generated, not empty


def test_select_and_prompt_helpers_match_jax():
    cases = [(["a", "", "b"], [-1.0, 0.0, -0.5], None),
             (["", " "], [-1.0, -2.0], None),
             (["paris", "lyon", "x"], [-3.0, -1.0, -0.1], ["Paris is big", "no", "none"]),
             (["q", "r"], [-1.0, -1.0], ["q r", "q r"]),
             (["z"], [float("nan")], ["z"])]
    for texts, lps, ctx in cases:
        assert evaluate.select_best_candidate(texts, lps, ctx) == \
            jax_evaluate.select_best_candidate(texts, lps, ctx)
    assert evaluate.build_qa_prompt("Q?", "C.") == jax_evaluate.build_qa_prompt("Q?", "C.")
    llm, jllm = ScoredMock(["b", "a"]), JaxScoredMock(["b", "a"])
    assert evaluate.generate_answer_per_passage(llm, "q", ["a x", "", "b y"]) == \
        jax_evaluate.generate_answer_per_passage(jllm, "q", ["a x", "", "b y"])
    assert evaluate.generate_answer_per_passage(MockLLM(["m"]), "q", ["a", "b"]) == \
        jax_evaluate.generate_answer_per_passage(JaxMockLLM(["m"]), "q", ["a", "b"])


def test_main_with_jax_defaults_answers_like_the_jax_server(tmp_path, monkeypatch):
    """main() with its defaults loads models/encoder and models/tiny_lm on
    the CPU; /answer generates the JAX server's text on the same index
    (both generators decoding greedily, as above)."""
    with open("runs/demo_full_r4/corpus.jsonl") as f:
        rows = [json.loads(line) for line, _ in zip(f, range(24))]
    ids = {r["id"] for r in rows}
    with open("runs/demo_full_r4/nq.jsonl") as f:
        qa = [row for row in map(json.loads, f) if row["gold_doc_ids"][0] in ids]
    bm25_path, dense_dir = str(tmp_path / "bm25.json"), str(tmp_path / "dense")
    src = HybridRetriever(bm25_persist_path=bm25_path, dense_persist_directory=dense_dir,
                          embedder=load_encoder_checkpoint("models/encoder/encoder.msgpack",
                                                           device="cpu"), device="cpu")
    src.add_documents([Document.from_dict(r) for r in rows])
    src.dense_index.save()
    ref = JaxRetriever(bm25_persist_path=bm25_path, dense_persist_directory=dense_dir,
                       embedder=jax_load_encoder("models/encoder/encoder.msgpack"))
    assert len(ref) == 24
    jsvc = JaxQueryService(ref, tick_ms=1.0)
    questions = [row["question"] for row in qa[:2]]
    real_forever = serve_mod.ThreadingHTTPServer.serve_forever
    seen = {}

    def serve_some(server):
        thread = threading.Thread(target=real_forever, args=(server,), daemon=True)
        thread.start()
        try:
            seen["ours"] = [_call(server.server_address[1], "/answer", {"question": q})
                            for q in questions]
        finally:
            server.shutdown()
            thread.join(timeout=10)

    monkeypatch.setattr(serve_mod.ThreadingHTTPServer, "serve_forever", serve_some)
    loaded = []
    real_load = serve_mod.load_lm_checkpoint

    def load_greedy(path, **kw):
        loaded.append(path)
        return Greedy(real_load(path, **kw), max_tokens=100)

    monkeypatch.setattr(serve_mod, "load_lm_checkpoint", load_greedy)
    serve_mod.main(["--bm25-path", bm25_path, "--dense-dir", dense_dir, "--port", "0",
                    "--device", "cpu"])
    assert loaded == ["models/tiny_lm/tiny_lm.msgpack"]
    jllm = Greedy(jax_load_lm("models/tiny_lm/tiny_lm.msgpack"), max_tokens=100)
    jserver = jax_serve_http(jsvc, llm=jllm, port=0)
    thread = threading.Thread(target=real_forever, args=(jserver,), daemon=True)
    thread.start()
    try:
        refs = [_call(jserver.server_address[1], "/answer", {"question": q}) for q in questions]
    finally:
        jserver.shutdown()
        jserver.server_close()
        jsvc.close()
        thread.join(timeout=10)
    for ours, jref in zip(seen["ours"], refs):
        assert ours["passages"][0]["doc_id"] == jref["passages"][0]["doc_id"]
        assert ours["answer"] and ours["answer"] != ours["passages"][0]["text"]
        assert ours["answer"] == jref["answer"]
