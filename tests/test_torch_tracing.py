"""The port's tracer (``rag_uq_tpu_torch/utils/profiling.py``) on the CPU.

Off, a span is the shared no-op context: no record, no CUDA event, no
``record_function``. On, spans nest by thread with the right parent and
root ids, counters add up, spans past the cap are counted, each span opens
a ``torch.profiler`` range of its name, and a scatter-mode
``hybrid_search_batch`` yields the span tree the tracer's docstring lists,
with the high tier's row counters equal to a recount of
``encode_for_fused``'s own outputs and every query hashed by the native
library (by the Python twin once the library is made unavailable).
"""

import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.native import binding  # noqa: E402
from rag_uq_tpu_torch.retrieval import fused as fused_mod  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402
from rag_uq_tpu_torch.utils import build, profiling  # noqa: E402

SEARCH_TREE = {
    "search": None,
    "search.state": "search",
    "embed": "search",
    "embed.hash": "embed",
    "embed.bag": "embed",
    "embed.readback": "embed",
    "embed.upload": "embed",
    "terms": "search",
    "terms.tokenize": "terms",
    "terms.compact": "terms",
    "fused": "search",
    "fused.dense_pool": "fused",
    "fused.bm25_pool": "fused",
    "fused.tail": "fused",
    "search.readback": "search",
}


@pytest.fixture
def tracer():
    profiling.take()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.take()


def _corpus(n=300):
    rng = np.random.default_rng(5)
    ranks = np.arange(1, 401, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return [" ".join(f"w{w}" for w in rng.choice(400, size=int(rng.integers(8, 40)), p=p))
            for _ in range(n)]


def _queries(docs, n=24):
    rng = np.random.default_rng(9)
    out = []
    for i in rng.integers(0, len(docs), size=n):
        toks = docs[i].split()
        out.append(" ".join(rng.choice(toks, size=min(5, len(toks)), replace=False)))
    return out


def _retriever(docs):
    r = HybridRetriever(
        embedder=NgramHashEmbedder(dim=32, buckets=1024, max_len=32, device="cpu"),
        bm25_config=BM25Config(dense_tier_threshold=8),
        dense_config=DenseIndexConfig(embedding_dim=32, initial_capacity=128, score_block=128),
        device="cpu",
    )
    r.add_documents([Document(str(i), t) for i, t in enumerate(docs)])
    return r


@pytest.fixture(scope="module")
def corpus():
    docs = _corpus()
    return docs, _queries(docs)


def _search(r, queries):
    return r.hybrid_search_batch(queries, top_k=5, retrieval_pool_size=10, sparse_mode="scatter")


def test_off_records_nothing_and_touches_neither_events_nor_ranges(corpus, monkeypatch):
    docs, queries = corpus
    r = _retriever(docs)
    profiling.disable()
    profiling.take()

    def refuse(*args, **kwargs):
        raise AssertionError("called while the tracer is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("a") is profiling.span("b", cuda=True, n=3)
    with profiling.span("a", cuda=True):
        profiling.count("c", 5)
    _search(r, queries)
    assert profiling.take() == {"spans": [], "counters": {}, "dropped": 0}


def test_nested_spans_keep_their_parent_and_root_in_each_thread(tracer):
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracer.span(f"{tag}.outer", n=7):
            barrier.wait()
            with tracer.span(f"{tag}.mid"):
                barrier.wait()
                with tracer.span(f"{tag}.inner"):
                    tracer.count("hits", 2)
            tracer.count("hits")

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    rec = tracer.take()
    assert rec["counters"] == {"hits": 6} and rec["dropped"] == 0
    by = {s.name: s for s in rec["spans"]}
    assert set(by) == {f"{t}.{p}" for t in "ab" for p in ("outer", "mid", "inner")}
    for t in "ab":
        outer, mid, inner = by[f"{t}.outer"], by[f"{t}.mid"], by[f"{t}.inner"]
        assert outer.parent is None and outer.root == outer.id and outer.n == 7
        assert mid.parent == outer.id and inner.parent == mid.id
        assert mid.root == inner.root == outer.id
        assert outer.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns
        assert inner.end_ns <= mid.end_ns <= outer.end_ns
        assert inner.cuda_ms is None and inner.host_ms >= 0
    assert by["a.outer"].id != by["b.outer"].id
    assert tracer.take() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_past_the_cap_are_counted(tracer, monkeypatch):
    monkeypatch.setattr(tracer, "CAP", 5)
    for i in range(12):
        with tracer.span("s", n=i):
            pass
    rec = tracer.take()
    assert [s.n for s in rec["spans"]] == [0, 1, 2, 3, 4] and rec["dropped"] == 7
    with tracer.span("after"):
        pass
    assert [s.name for s in tracer.take()["spans"]] == ["after"]


def test_each_span_opens_a_profiler_range_of_its_name(tracer):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("outer.range"):
            with tracer.span("inner.range"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"outer.range", "inner.range"} <= names


def test_a_scatter_search_yields_the_span_tree_and_the_high_tier_counts(corpus, tracer,
                                                                      monkeypatch):
    docs, queries = corpus
    r = _retriever(docs)
    rec = tracer.take()
    assert {"bm25.build", "dense.add"} <= {s.name for s in rec["spans"]}
    # What encode_for_fused hands the pool, recounted from its own outputs.
    recount = []
    real = fused_mod.encode_for_fused

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        compact = out["rows_compact"].numpy()
        recount.append((np.unique(compact[compact >= 0]).size, out["active_rows"].shape[0]))
        return out

    monkeypatch.setattr("rag_uq_tpu_torch.retrieval.hybrid.encode_for_fused", recorded)
    calls = [queries, queries[:7], queries]
    for qs in calls:
        _search(r, qs)
    rec = tracer.take()
    spans = rec["spans"]
    roots = [s for s in spans if s.name == "search"]
    assert [s.n for s in roots] == [len(qs) for qs in calls]
    by_id = {s.id: s for s in spans}
    per_root = {root.id: {} for root in roots}
    for s in spans:
        assert s.root in per_root, s
        per_root[s.root][s.name] = s
    for tree in per_root.values():
        # The first search builds the BM25 device layout; the others reuse it.
        tree.pop("bm25.sync", None)
        assert set(tree) == set(SEARCH_TREE)
        for name, parent in SEARCH_TREE.items():
            s = tree[name]
            assert (by_id[s.parent].name if s.parent is not None else None) == parent
            assert s.cuda_ms is None
    assert sum(s.name == "bm25.sync" for s in spans) == 1
    assert rec["counters"]["bm25.syncs"] == 1 and rec["counters"]["fused_state.rebuilds"] == 1
    active, padded = map(sum, zip(*recount))
    assert 0 < active <= padded and len(recount) == len(calls)
    assert rec["counters"]["bm25.high_rows_active"] == active
    assert rec["counters"]["bm25.high_rows_padded"] == padded
    assert rec["dropped"] == 0


@pytest.mark.parametrize("library", ["native", "unavailable"])
def test_a_search_counts_the_queries_each_hashing_path_hashed(corpus, tracer, monkeypatch,
                                                             library):
    docs, queries = corpus
    r = _retriever(docs)
    assert binding.is_available()
    if library == "unavailable":
        monkeypatch.setattr(binding, "_get_lib", lambda: None)
    tracer.take()
    _search(r, queries)
    rec = tracer.take()
    hashed, other = (("embed.hash_native", "embed.hash_python") if library == "native"
                     else ("embed.hash_python", "embed.hash_native"))
    assert rec["counters"][hashed] == len(queries) and other not in rec["counters"]
    by_id = {s.id: s for s in rec["spans"]}
    (hash_span,) = [s for s in rec["spans"] if s.name == "embed.hash"]
    assert by_id[hash_span.parent].name == "embed"


def test_twotier_search_has_no_compaction_and_counts_no_high_rows(corpus, tracer):
    docs, queries = corpus
    r = _retriever(docs)
    tracer.take()
    r.hybrid_search_batch(queries, top_k=5, retrieval_pool_size=10, sparse_mode="twotier")
    rec = tracer.take()
    names = {s.name for s in rec["spans"]}
    assert "terms.compact" not in names and {"terms", "fused.bm25_pool"} <= names
    assert "bm25.high_rows_active" not in rec["counters"]


def test_a_compile_and_a_cache_hit_are_counted(tracer, tmp_path, monkeypatch):
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "out"))
    src = tmp_path / "k.c"
    src.write_text("int f(void) { return 1; }\n")
    # A stand-in compiler: writes the output file named after -o.
    command = [sys.executable, "-c", "import sys; open(sys.argv[2], 'w').write('x')"]
    first = build.build_shared_library("k", [src], command, timeout_s=60)
    again = build.build_shared_library("k", [src], command, timeout_s=60)
    assert first.path == again.path and again.seconds == 0.0
    rec = tracer.take()
    assert rec["counters"] == {"build.compiles": 1, "build.cache_hits": 1}
    assert [s.name for s in rec["spans"]] == ["build.compile"]
