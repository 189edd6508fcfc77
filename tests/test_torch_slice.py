"""The port's batched hybrid query and QueryService against the JAX package
on a small corpus (300 docs, D = 64), both sides with the same hash table
(``convert.embedding_table``).

Tolerances: embeddings within 1e-2 absolute per component, and at least
99% of components equal (a bf16-rounded f32 sum taken in another order can
round one bf16 step apart); final hybrid
results agree under the tie rule, rank-wise scores within rtol 1e-4 /
atol 1e-5 (so a near-tie closer than that may swap), and at least 99% of
queries identical position by position.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.cli.serve import QueryService as JaxQueryService  # noqa: E402
from rag_uq_tpu.core.config import DenseIndexConfig as JaxDenseConfig  # noqa: E402
from rag_uq_tpu.core.config import router_recipe_v2 as jax_recipe  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxEmbedder  # noqa: E402
from rag_uq_tpu.retrieval.hybrid import HybridRetriever as JaxRetriever  # noqa: E402
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.cli.serve import QueryService  # noqa: E402
from rag_uq_tpu_torch.convert import embedding_table, load_router  # noqa: E402
from rag_uq_tpu_torch.core.config import DenseIndexConfig, RouterConfig  # noqa: E402
from rag_uq_tpu_torch.core.config import router_recipe_v2  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402
from rag_uq_tpu_torch.router.model import RetrievalRouter  # noqa: E402

DIM, BUCKETS, N_DOCS = 64, 4096, 300


def _corpus():
    rng = np.random.default_rng(17)
    ranks = np.arange(1, 501, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    docs = []
    for _ in range(N_DOCS):
        words = rng.choice(500, size=int(rng.integers(8, 40)), p=p)
        docs.append(" ".join(f"w{w}" for w in words))
    return docs


def _queries(docs, n=40):
    rng = np.random.default_rng(23)
    out = []
    for i in rng.integers(0, len(docs), size=n):
        toks = docs[i].split()
        out.append(" ".join(rng.choice(toks, size=min(4, len(toks)), replace=False)))
    return out + ["unknownterm", "", "w0 w0 w1"]


@pytest.fixture(scope="module")
def pair():
    docs = _corpus()
    jax_emb = JaxEmbedder(dim=DIM, buckets=BUCKETS)
    cfg = dict(embedding_dim=DIM, initial_capacity=128, score_block=128)
    ref = JaxRetriever(embedder=jax_emb, dense_config=JaxDenseConfig(**cfg))
    ref.add_documents([JaxDocument(str(i), t) for i, t in enumerate(docs)])
    table = embedding_table(np.asarray(jax_emb.table, dtype=np.float32))
    ours = HybridRetriever(
        embedder=NgramHashEmbedder(dim=DIM, buckets=BUCKETS, table=table, device="cpu"),
        dense_config=DenseIndexConfig(**cfg), device="cpu",
    )
    ours.add_documents([Document(str(i), t) for i, t in enumerate(docs)])
    return docs, ref, ours


def _routers(kind):
    if kind == "none":
        return None, None
    if kind == "recipe_v2":
        ref = JaxRouter(jax_recipe(), seed=2)
        ours = RetrievalRouter(router_recipe_v2(), device="cpu")
    else:
        ref = JaxRouter(seed=2)
        ours = RetrievalRouter(RouterConfig(), device="cpu")
    import jax

    load_router(ours, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.stats))
    if kind == "clamped":
        ref.trained_num_passages = ours.trained_num_passages = 8
    return ref, ours


def _assert_agree(tv, tp, jv, jp):
    agree = tie_aware_agreement(tv, tp, jv, jp, rtol=1e-4, atol=1e-5)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]
    assert agree["raw_idx_agreement"] >= 0.99, agree


def test_hash_embedder_matches_jax(pair):
    docs, ref, ours = pair
    texts = docs[:50] + _queries(docs)
    je = ref.dense_index.embedder.encode(texts)
    te = ours.dense_index.embedder.encode(texts)
    np.testing.assert_allclose(te, je, atol=1e-2, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), np.linalg.norm(je, axis=1), atol=1e-5)
    dense_ours = ours.dense_index._emb.float().numpy()
    dense_ref = np.asarray(ref.dense_index._emb, dtype=np.float32)
    assert np.abs(dense_ours - dense_ref).max() <= 1e-2
    assert (dense_ours == dense_ref).mean() >= 0.99


@pytest.mark.parametrize("router", ["none", "default", "recipe_v2", "clamped"])
def test_hybrid_search_batch_matches_jax(pair, router):
    docs, ref, ours = pair
    jr, tr = _routers(router)
    queries = _queries(docs)
    jv, jp = ref.hybrid_search_batch(queries, top_k=10, router=jr, approx=False,
                                     sparse_mode="scatter")
    tv, tp = ours.hybrid_search_batch(queries, top_k=10, router=tr, approx=False,
                                      sparse_mode="scatter")
    assert tv.shape == tp.shape == (len(queries), 10) and tp.dtype == np.int32
    _assert_agree(tv, tp, np.asarray(jv), np.asarray(jp))


def test_fused_query_with_exact_bm25_matches_jax(pair):
    """The exhaustive-BM25 variant of the fused query (exact_bm25=True)."""
    from rag_uq_tpu.retrieval.fused import encode_for_fused as jax_encode
    from rag_uq_tpu.retrieval.fused import make_fused_hybrid_query as jax_make
    from rag_uq_tpu_torch.retrieval.fused import encode_for_fused, make_fused_hybrid_query

    docs, ref, ours = pair
    queries = _queries(docs)[:12]
    max_df = ref.bm25_index._sync()["max_df"]
    jfn = jax_make(k=10, pool=50, approx_topk=False, exact_bm25=True, max_df=max_df,
                   dense_mode="stream", block=128)
    jv, jp = jfn(ref._fused_state(), ref.dense_index.embed_queries(queries),
                 jax_encode(ref.bm25_index, queries))
    tfn = make_fused_hybrid_query(k=10, pool=50, exact_bm25=True, max_df=max_df,
                                  dense_mode="stream", block=128)
    tv, tp = tfn(ours._fused_state(), ours.dense_index.embed_queries(queries),
                 encode_for_fused(ours.bm25_index, queries))
    _assert_agree(tv.numpy(), tp.numpy(), np.asarray(jv), np.asarray(jp))


def test_twotier_waits_for_next_slice(pair):
    """Once a refusal, now a parity check: hybrid_search_batch with no
    sparse_mode (the JAX default, "twotier") matches the JAX call."""
    docs, ref, ours = pair
    queries = _queries(docs)
    jv, jp = ref.hybrid_search_batch(queries, top_k=10)
    tv, tp = ours.hybrid_search_batch(queries, top_k=10)
    _assert_agree(tv, tp, np.asarray(jv), np.asarray(jp))


def test_query_service_matches_jax(pair):
    docs, ref, ours = pair
    queries = _queries(docs)[:16]
    jr, tr = _routers("recipe_v2")
    jsvc = JaxQueryService(ref, router=jr, max_batch=64, tick_ms=1.0)
    tsvc = QueryService(ours, router=tr, max_batch=64, tick_ms=1.0)
    try:
        jhits = jsvc.search(queries, k=5)
        thits = tsvc.search(queries, k=5)
        jsingle = jsvc.search([queries[0]], k=3)
        single = tsvc.search([queries[0]], k=3)
    finally:
        jsvc.close()
        tsvc.close()
    assert tsvc.stats["queries"] == len(queries) + 1 and tsvc.stats["batches"] == 2
    assert len(thits) == len(jhits) == len(queries)
    same = 0
    for t, j in zip(thits, jhits):
        assert len(t) == len(j)
        np.testing.assert_allclose([h["score"] for h in t], [h["score"] for h in j],
                                   rtol=1e-4, atol=1e-5)
        same += [h["doc_id"] for h in t] == [h["doc_id"] for h in j]
    assert same >= len(queries) - 1
    assert [h["doc_id"] for h in single[0]] == [h["doc_id"] for h in jsingle[0]]


def test_query_service_ingest_then_search(pair):
    """Ingest runs on the worker thread; the next search sees the new doc."""
    docs, _, _ = pair
    r = HybridRetriever(
        embedder=NgramHashEmbedder(dim=DIM, buckets=BUCKETS, device="cpu"),
        dense_config=DenseIndexConfig(embedding_dim=DIM, initial_capacity=128,
                                      score_block=128),
        device="cpu",
    )
    r.add_documents([Document(str(i), t) for i, t in enumerate(docs[:50])])
    svc = QueryService(r, max_batch=8, tick_ms=1.0)
    try:
        added = svc.ingest([Document("new", "zzyzx quokka")])
        hits = svc.search(["zzyzx quokka"], k=3)[0]
    finally:
        svc.close()
    assert added["bm25_added"] == 1 and hits[0]["doc_id"] == "new"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridRetriever(embedder=NgramHashEmbedder(dim=8, buckets=16, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalRouter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NgramHashEmbedder(dim=8, buckets=16)


def test_fused_query_keeps_jax_shapes_for_tiny_index():
    """Fewer docs than the pool: the pool and k shrink as in the JAX path."""
    r = HybridRetriever(
        embedder=NgramHashEmbedder(dim=16, buckets=64, device="cpu"),
        dense_config=DenseIndexConfig(embedding_dim=16, initial_capacity=16, score_block=16),
        device="cpu",
    )
    r.add_documents([Document("a", "alpha beta"), Document("b", "beta gamma")])
    vals, pos = r.hybrid_search_batch(["beta", "delta"], top_k=10, sparse_mode="scatter")
    assert pos.shape == (2, 4)
    assert set(pos[0][pos[0] >= 0].tolist()) == {0, 1}
    assert vals.dtype == np.float32
