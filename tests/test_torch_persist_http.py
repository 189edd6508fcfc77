"""Index persistence across the two packages, the streaming ingest, the
build CLI and the HTTP front end, on the CPU.

An index saved by either package loads in the other and answers the same
queries identically (exact: both read the same postings and the same f32
vectors, and round them to bf16 alike). The HTTP responses match the JAX
server's on the same index: hit ids equal, scores within rtol 1e-4 /
atol 1e-5 (the fused scores of the two packages, as in
``test_torch_slice.py``).
"""

import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.cli.serve import QueryService as JaxQueryService  # noqa: E402
from rag_uq_tpu.cli.serve import serve_http as jax_serve_http  # noqa: E402
from rag_uq_tpu.core.config import BM25Config as JaxBM25Config  # noqa: E402
from rag_uq_tpu.core.config import DenseIndexConfig as JaxDenseConfig  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import Sha256Embedder as JaxSha256  # noqa: E402
from rag_uq_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index  # noqa: E402
from rag_uq_tpu.uq.conformal import ConformalRAG as JaxConformal  # noqa: E402
from rag_uq_tpu_torch.cli import serve as serve_mod  # noqa: E402
from rag_uq_tpu_torch.cli.build_index import build_index_from_jsonl, verify_index  # noqa: E402
from rag_uq_tpu_torch.cli.serve import QueryService, serve_http  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig  # noqa: E402
from rag_uq_tpu_torch.core.config import Config, EmbedderConfig  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import Sha256Embedder  # noqa: E402
from rag_uq_tpu_torch.index.build import StreamingIndex  # noqa: E402
from rag_uq_tpu_torch.index.dense import DenseIndex  # noqa: E402
from rag_uq_tpu_torch.index.sparse import BM25Index  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402
from rag_uq_tpu_torch.uq.conformal import ConformalRAG  # noqa: E402

from tests.test_torch_serving import add, make_corpus, make_queries, retriever_pair  # noqa: E402

QUERIES = ["w1 w2 w3", "w0", "w7 w11 w0", "unknownterm", ""]
DENSE = dict(embedding_dim=100, initial_capacity=64, score_block=64)


def _docs(n=80, seed=41):
    return [(f"d{i}", t) for i, t in enumerate(make_corpus(n, seed=seed))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bm25_persistence_across_packages(tmp_path, writer):
    path = str(tmp_path / "bm25.json")
    docs = _docs()
    if writer == "port":
        src = BM25Index(persist_path=path, device="cpu", autosave=False)
        src.add_documents([Document(i, t, "title", {"n": 1}) for i, t in docs])
        src.save()
        loaded = JaxBM25Index(persist_path=path)
    else:
        src = JaxBM25Index(persist_path=path, autosave=False)
        src.add_documents([JaxDocument(i, t, "title", {"n": 1}) for i, t in docs])
        src.save()
        loaded = BM25Index(persist_path=path, device="cpu")
    assert len(loaded) == len(src) == 80 and loaded.store.ids == src.store.ids
    assert loaded.get_document("d3").metadata == {"n": 1}
    for exact in (True, False):
        sv, si = src.search_batch(QUERIES, top_k=6, exact=exact)
        lv, li = loaded.search_batch(QUERIES, top_k=6, exact=exact)
        np.testing.assert_allclose(np.asarray(sv), np.asarray(lv), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(si), np.asarray(li))


def test_bm25_autosave_and_reload(tmp_path):
    path = tmp_path / "sub" / "bm25.json"
    idx = BM25Index(persist_path=str(path), device="cpu")
    idx.add_documents([Document("a", "alpha beta"), Document("b", "beta gamma"),
                       Document("c", "delta")])
    assert path.exists() and path.with_suffix(".npz").exists()
    again = BM25Index(persist_path=str(path), device="cpu")
    assert again.search("gamma") == idx.search("gamma") and again.search("gamma")[0][0] == "b"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dense_persistence_across_packages(tmp_path, writer):
    """D = 100: saved at the true width, stored padded by the port."""
    out = str(tmp_path / "dense")
    docs = _docs()
    if writer == "port":
        src = DenseIndex(embedder=Sha256Embedder(100), config=DenseIndexConfig(**DENSE),
                         device="cpu")
        src.add_documents([Document(i, t) for i, t in docs], batch_size=32)
        src.save(out)
        loaded = JaxDenseIndex(embedder=JaxSha256(100), config=JaxDenseConfig(**DENSE),
                               persist_directory=out)
    else:
        src = JaxDenseIndex(embedder=JaxSha256(100), config=JaxDenseConfig(**DENSE))
        src.add_documents([JaxDocument(i, t) for i, t in docs], batch_size=32)
        src.save(out)
        loaded = DenseIndex(embedder=Sha256Embedder(100), config=DenseIndexConfig(**DENSE),
                            persist_directory=out, device="cpu")
    assert np.load(os.path.join(out, "embeddings.npy")).shape == (80, 100)
    assert len(loaded) == 80 and loaded.store.texts == src.store.texts
    sv, si = src.search_batch(QUERIES, top_k=9)
    lv, li = loaded.search_batch(QUERIES, top_k=9)
    np.testing.assert_array_equal(np.asarray(sv), np.asarray(lv))
    np.testing.assert_array_equal(np.asarray(si), np.asarray(li))


def test_tokenizer_mismatch_guard(tmp_path):
    bm25_path = tmp_path / "bm25.json"
    idx = BM25Index(persist_path=str(bm25_path), device="cpu")
    idx.add_documents([Document("a", "alpha")])
    dense_dir = tmp_path / "dense"
    dense = DenseIndex(embedder=Sha256Embedder(16),
                       config=DenseIndexConfig(embedding_dim=16, initial_capacity=8,
                                               score_block=8), device="cpu")
    dense.add_documents([Document("a", "alpha")])
    dense.save(str(dense_dir))
    for meta_path in (bm25_path, dense_dir / "meta.json"):
        meta = json.loads(meta_path.read_text())
        meta["tokenizer"] = "v1-bare-split"
        meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="tokenizer"):
        BM25Index(persist_path=str(bm25_path), device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        JaxBM25Index(persist_path=str(bm25_path))
    cfg = dict(embedding_dim=16, initial_capacity=8, score_block=8)
    with pytest.raises(ValueError, match="tokenizer"):
        DenseIndex(embedder=Sha256Embedder(16), config=DenseIndexConfig(**cfg),
                   persist_directory=str(dense_dir), device="cpu")
    loaded = BM25Index(persist_path=str(bm25_path), device="cpu",
                       config=BM25Config(allow_tokenizer_mismatch=True))
    assert len(loaded) == 1


def test_retriever_loads_what_the_jax_retriever_saved(tmp_path):
    docs = make_corpus(60, seed=7)
    bm25_path, dense_dir = str(tmp_path / "bm25.json"), str(tmp_path / "dense")
    kw = dict(bm25_persist_path=bm25_path, dense_persist_directory=dense_dir)
    ref, ours_src = retriever_pair(docs, jax=kw)
    ref.dense_index.save()
    _, ours = retriever_pair([], ours=kw)
    assert len(ours) == 60 and len(ours.bm25_index) == 60
    queries = make_queries(docs, n=10)
    jv, jp = ref.hybrid_search_batch(queries, approx=False)
    tv, tp = ours.hybrid_search_batch(queries, approx=False)
    sv, sp = ours_src.hybrid_search_batch(queries, approx=False)
    np.testing.assert_array_equal(tp, sp)  # reloaded == built in the port
    np.testing.assert_array_equal(tv, sv)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)


# -- StreamingIndex and the build CLI ---------------------------------------------


def _write_corpus(path, n=30, malformed=True):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"id": f"d{i}", "text": f"passage about topic{i % 5} number {i}"})
                    + "\n")
            if malformed and i == 4:
                f.write("{not json\n")
                f.write(json.dumps({"text": "no id"}) + "\n")


def _small_retriever():
    return HybridRetriever(embedder=Sha256Embedder(32),
                           dense_config=DenseIndexConfig(embedding_dim=32, initial_capacity=32,
                                                         score_block=32), device="cpu")


def test_streaming_index_resume_and_malformed_lines(tmp_path):
    corpus = tmp_path / "corpus.jsonl"
    _write_corpus(corpus)
    ckpt = str(tmp_path / "ckpt.json")
    retriever = _small_retriever()
    counts = list(StreamingIndex(retriever, checkpoint_path=ckpt, batch_size=8)
                  .stream_from_jsonl(str(corpus)))
    assert sum(counts) == 30 and len(retriever) == 30  # the 2 bad lines skipped
    again = StreamingIndex(retriever, checkpoint_path=ckpt, batch_size=8)
    assert list(again.stream_from_jsonl(str(corpus))) == []  # resume: nothing new
    progress = again.get_progress()
    assert progress["total_indexed"] == 30 and progress["retriever_size"] == 30
    assert progress["files_completed"] == [str(corpus)]
    # The checkpoint is the JAX package's format: its StreamingIndex resumes it.
    from rag_uq_tpu.index.build import StreamingIndex as JaxStreamingIndex

    assert JaxStreamingIndex(None, checkpoint_path=ckpt).progress == again.progress


def test_build_index_cli_and_verify(tmp_path):
    corpus = tmp_path / "corpus.jsonl"
    _write_corpus(corpus, malformed=False)
    bm25_path, dense_dir = str(tmp_path / "bm25.json"), str(tmp_path / "dense")
    kw = dict(checkpoint_path=str(tmp_path / "c.json"), bm25_persist_path=bm25_path,
              dense_persist_directory=dense_dir, batch_size=7,
              config=Config(dense=DenseIndexConfig(embedding_dim=32, initial_capacity=32,
                                                   score_block=32),
                            embedder=EmbedderConfig(kind="sha256", dim=32)),
              device="cpu")
    retriever = build_index_from_jsonl(str(corpus), **kw)
    report = verify_index(retriever, ["topic3 number 8"])
    assert report["total_documents"] == report["bm25_documents"] == 30
    assert report["queries"]["topic3 number 8"][0]["doc_id"] == "d8"
    # Rerun: resumes, adds nothing, and the saved index reloads in both packages.
    again = build_index_from_jsonl(str(corpus), **kw)
    assert len(again) == 30
    assert len(JaxBM25Index(persist_path=bm25_path)) == 30
    assert len(JaxDenseIndex(embedder=JaxSha256(32), persist_directory=dense_dir,
                             config=JaxDenseConfig(embedding_dim=32, initial_capacity=32,
                                                   score_block=32))) == 30


# -- HTTP ----------------------------------------------------------------------------


def _call(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    if payload is None:
        req = urllib.request.Request(url)
    else:
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server.server_address[1], thread


def test_nonconformity_matches_jax():
    for pred, ctx in (("a b", "a b c d e"), ("", ""), ("x " * 30, "y")):
        assert ConformalRAG.estimate_nonconformity(pred, ctx) == \
            JaxConformal.estimate_nonconformity(pred, ctx)


def test_http_front_end_matches_jax_server():
    docs = make_corpus(120, seed=11)
    ref, ours = retriever_pair(docs, bm25=dict(delta_sync_fraction=0.5))
    jsvc, tsvc = JaxQueryService(ref, tick_ms=1.0), QueryService(ours, tick_ms=1.0)
    jserver, tserver = jax_serve_http(jsvc, port=0), serve_http(tsvc, port=0)
    jport, jthread = _serve(jserver)
    tport, tthread = _serve(tserver)
    try:
        assert _call(tport, "/healthz") == _call(jport, "/healthz") == \
            {"status": "ok", "documents": 120}
        queries = make_queries(docs, n=6)
        tres = _call(tport, "/search", {"queries": queries, "k": 4})["results"]
        jres = _call(jport, "/search", {"queries": queries, "k": 4})["results"]
        for t, j in zip(tres, jres):
            assert [h["doc_id"] for h in t] == [h["doc_id"] for h in j]
            assert [h["text"] for h in t] == [h["text"] for h in j]
            np.testing.assert_allclose([h["score"] for h in t], [h["score"] for h in j],
                                       rtol=1e-4, atol=1e-5)
        single = _call(tport, "/search", {"query": queries[0], "k": 2})["results"]
        assert [h["doc_id"] for h in single[0]] == [h["doc_id"] for h in tres[0][:2]]

        device = ours.bm25_index._device
        new = {"documents": [{"id": "live9", "text": "freshly ingested zzzdoc w1"}]}
        tstats, jstats = _call(tport, "/ingest", new), _call(jport, "/ingest", new)
        assert tstats == jstats and tstats["total_documents"] == 121
        thits = _call(tport, "/search", {"queries": ["zzzdoc freshly"], "k": 2})["results"][0]
        jhits = _call(jport, "/search", {"queries": ["zzzdoc freshly"], "k": 2})["results"][0]
        assert thits[0]["doc_id"] == jhits[0]["doc_id"] == "live9"
        assert ours.bm25_index._delta_device is not None  # no full resync
        assert ours.bm25_index._device is device

        tans = _call(tport, "/answer", {"question": queries[1], "k": 3})
        jans = _call(jport, "/answer", {"question": queries[1], "k": 3})
        assert tans["answer"] == jans["answer"] == tans["passages"][0]["text"]
        assert tans["confidence"] == pytest.approx(jans["confidence"])
        wide = _call(tport, "/answer", {"question": queries[1], "context_passages": 3})
        assert wide["confidence"] == pytest.approx(_call(jport, "/answer", {
            "question": queries[1], "context_passages": 3})["confidence"])

        for path, payload, code in (("/nowhere", None, 404), ("/nowhere", {}, 404),
                                    ("/search", b"{bad", 400),
                                    ("/ingest", {"documents": [{"text": "no id"}]}, 400)):
            for port in (tport, jport):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _call(port, path, payload)
                assert err.value.code == code, (path, port)
    finally:
        for server, svc in ((tserver, tsvc), (jserver, jsvc)):
            server.shutdown()
            server.server_close()
            svc.close()
        tthread.join(timeout=10)
        jthread.join(timeout=10)
    assert not tthread.is_alive() and not jthread.is_alive()


def test_http_twotier_service_ingest_then_search():
    docs = make_corpus(40, seed=13)
    _, ours = retriever_pair(docs, bm25=dict(delta_sync_fraction=0.5))
    svc = QueryService(ours, sparse_mode="twotier", tick_ms=1.0)
    server = serve_http(svc, port=0)
    port, thread = _serve(server)
    try:
        _call(port, "/search", {"queries": ["w1"], "k": 2})
        _call(port, "/ingest", {"documents": [{"id": "n", "text": "quokka zzyzx"}]})
        hits = _call(port, "/search", {"queries": ["quokka zzyzx"], "k": 2})["results"][0]
        assert hits[0]["doc_id"] == "n" and ours.bm25_index._delta_device is not None
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=10)


CHECKPOINT_FLAGS = {
    "--encoder-checkpoint": "models/encoder/encoder.msgpack",
    "--lm-checkpoint": "models/tiny_lm/tiny_lm.msgpack",
    "--router-checkpoint": "runs/demo_full_r4/router/best_router.msgpack",
}


@pytest.mark.parametrize("flag", list(CHECKPOINT_FLAGS))
def test_main_names_the_roadmap_item_of_unported_checkpoints(tmp_path, monkeypatch, flag):
    """Each checkpoint flag (once refused, before its module was ported)
    now loads its in-repo checkpoint on the CPU, with the weights the JAX
    loader reads from the same file."""
    import jax

    from rag_uq_tpu.embed.train import load_encoder_checkpoint as jax_load_encoder
    from rag_uq_tpu.llm.train import load_lm_checkpoint as jax_load_lm
    from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter
    from rag_uq_tpu.router.train import RouterTrainer
    from rag_uq_tpu_torch.convert import load_encoder, load_router, load_tiny_lm
    from rag_uq_tpu_torch.embed.encoder import TransformerEmbedder
    from rag_uq_tpu_torch.llm.tiny_lm import TinyLM
    from rag_uq_tpu_torch.router.model import RetrievalRouter

    seen = {}

    class Stub:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def capture(service, llm=None, **kw):
        seen.update(service=service, llm=llm, **kw)
        return Stub()

    monkeypatch.setattr(serve_mod, "serve_http", capture)
    args = {"--encoder-checkpoint": "", "--lm-checkpoint": "", flag: CHECKPOINT_FLAGS[flag]}
    argv = ["--bm25-path", str(tmp_path / "bm25.json"), "--dense-dir", str(tmp_path / "dense"),
            "--device", "cpu"]
    for name, value in args.items():
        argv += [name, value]
    serve_mod.main(argv)
    path = CHECKPOINT_FLAGS[flag]
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    if flag == "--encoder-checkpoint":
        loaded = seen["service"].retriever.dense_index.embedder
        ref = jax_load_encoder(path)
        expected = load_encoder(TransformerEmbedder(loaded.config, device="cpu"), to_np(ref.params))
        assert vars(loaded.config) == vars(ref.config) and seen["llm"] is None
    elif flag == "--lm-checkpoint":
        loaded = seen["llm"]
        ref = jax_load_lm(path)
        expected = load_tiny_lm(TinyLM(loaded.config, device="cpu"), to_np(ref.params))
        assert vars(loaded.config) == vars(ref.config)
    else:
        loaded = seen["service"].router
        ref = JaxRouter()
        RouterTrainer(ref).load_checkpoint(path)
        expected = load_router(RetrievalRouter(loaded.config, device="cpu"), to_np(ref.params),
                               to_np(ref.stats))
        assert vars(loaded.config) == vars(ref.config)
        assert loaded.trained_num_passages == ref.trained_num_passages == 20
    module = (lambda obj: obj.module) if flag == "--router-checkpoint" else (lambda obj: obj.model)
    ours_state, ref_state = module(loaded).state_dict(), module(expected).state_dict()
    assert list(ours_state) == list(ref_state) and ours_state
    for key, value in ref_state.items():
        assert torch.equal(ours_state[key], value), key
    seen["service"].close()


def test_main_serves_a_saved_index(tmp_path, monkeypatch):
    """main() loads the persisted index and serves it: its serve_forever
    answers one /search from another thread, then shuts down."""
    docs = make_corpus(30, seed=5)
    bm25_path, dense_dir = str(tmp_path / "bm25.json"), str(tmp_path / "dense")
    src = HybridRetriever(bm25_persist_path=bm25_path, dense_persist_directory=dense_dir,
                          device="cpu")
    src.add_documents([Document(str(i), t) for i, t in enumerate(docs)])
    src.dense_index.save()
    real_forever = serve_mod.ThreadingHTTPServer.serve_forever
    seen = {}

    def serve_one(server):
        thread = threading.Thread(target=real_forever, args=(server,), daemon=True)
        thread.start()
        try:
            seen["results"] = _call(server.server_address[1], "/search",
                                    {"queries": [docs[3]], "k": 1})["results"]
        finally:
            server.shutdown()
            thread.join(timeout=10)

    monkeypatch.setattr(serve_mod.ThreadingHTTPServer, "serve_forever", serve_one)
    serve_mod.main(["--bm25-path", bm25_path, "--dense-dir", dense_dir, "--port", "0",
                    "--sparse-mode", "twotier", "--device", "cpu",
                    "--encoder-checkpoint", "", "--lm-checkpoint", ""])
    assert seen["results"][0][0]["doc_id"] == "3"
