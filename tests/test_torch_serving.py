"""The port's scoring searches, router rerank and fused query with a live
delta, against the JAX package on the same inputs (``device="cpu"``).

Both sides embed with the same hash table (``convert.embedding_table``) or
the deterministic ``Sha256Embedder``. Tolerances: dense scores within 1e-6
(f32 sums of the same bf16 products in another order) with indices
tie-aware; union-pool scores within rtol 1e-5 / atol 1e-6; fused results
under the tie rule with rank-wise scores within rtol 1e-4 / atol 1e-5, and
at least 99% of queries identical position by position; router weights
within 1e-5.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_uq_tpu.core.config import BM25Config as JaxBM25Config  # noqa: E402
from rag_uq_tpu.core.config import DenseIndexConfig as JaxDenseConfig  # noqa: E402
from rag_uq_tpu.core.config import router_recipe_v2 as jax_recipe  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxNgram  # noqa: E402
from rag_uq_tpu.embed.hash_embed import Sha256Embedder as JaxSha256  # noqa: E402
from rag_uq_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from rag_uq_tpu.retrieval.hybrid import HybridRetriever as JaxRetriever  # noqa: E402
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.convert import embedding_table, load_router  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig  # noqa: E402
from rag_uq_tpu_torch.core.config import router_recipe_v2  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder, Sha256Embedder  # noqa: E402
from rag_uq_tpu_torch.index.dense import DenseIndex  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402
from rag_uq_tpu_torch.router.model import RetrievalRouter  # noqa: E402

DIM, BUCKETS, N_DOCS = 64, 4096, 200
DENSE = dict(embedding_dim=DIM, initial_capacity=128, score_block=128)


def make_corpus(n, seed=17, vocab=300):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return [
        " ".join(f"w{w}" for w in rng.choice(vocab, size=int(rng.integers(8, 40)), p=p))
        for _ in range(n)
    ]


def make_queries(docs, n=30, seed=23):
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.integers(0, len(docs), size=n):
        toks = docs[i].split()
        out.append(" ".join(rng.choice(toks, size=min(4, len(toks)), replace=False)))
    return out + ["unknownterm", "", "w0 w0 w1"]


def embedders():
    jax_emb = JaxNgram(dim=DIM, buckets=BUCKETS)
    table = embedding_table(np.asarray(jax_emb.table, dtype=np.float32))
    return jax_emb, NgramHashEmbedder(dim=DIM, buckets=BUCKETS, table=table, device="cpu")


def retriever_pair(docs, bm25=None, **kw):
    jax_emb, ours_emb = embedders()
    ref = JaxRetriever(embedder=jax_emb, dense_config=JaxDenseConfig(**DENSE),
                       bm25_config=JaxBM25Config(**(bm25 or {})), **kw.get("jax", {}))
    ours = HybridRetriever(embedder=ours_emb, dense_config=DenseIndexConfig(**DENSE),
                           bm25_config=BM25Config(**(bm25 or {})), device="cpu",
                           **kw.get("ours", {}))
    add(ref, ours, [(str(i), t) for i, t in enumerate(docs)])
    return ref, ours


def add(ref, ours, docs):
    ref.add_documents([JaxDocument(i, t) for i, t in docs])
    ours.add_documents([Document(i, t) for i, t in docs])


@pytest.fixture(scope="module")
def pair():
    docs = make_corpus(N_DOCS)
    ref, ours = retriever_pair(docs)
    return docs, ref, ours


def routers(kind):
    ref = JaxRouter(jax_recipe(), seed=2)
    ours = RetrievalRouter(router_recipe_v2(), device="cpu")
    load_router(ours, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.stats))
    if kind == "clamped":
        ref.trained_num_passages = ours.trained_num_passages = 8
    return ref, ours


def assert_fused_agree(tv, tp, jv, jp):
    agree = tie_aware_agreement(tv, tp, np.asarray(jv), np.asarray(jp), rtol=1e-4, atol=1e-5)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]
    assert agree["raw_idx_agreement"] >= 0.99, agree


# -- DenseIndex --------------------------------------------------------------------


@pytest.mark.parametrize("dim", [64, 100])
def test_dense_searches_match_jax(dim):
    """D = 100 is stored padded to 104 and answers as the JAX index does;
    top_k = 300 is above the heap kernel's limit (the CPU route here)."""
    rng = np.random.default_rng(dim)
    n = 400
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    cfg = dict(embedding_dim=dim, initial_capacity=512, score_block=512)
    ours = DenseIndex(embedder=Sha256Embedder(dim), config=DenseIndexConfig(**cfg), device="cpu")
    ref = JaxDenseIndex(embedder=JaxSha256(dim), config=JaxDenseConfig(**cfg))
    docs = [(str(i), f"passage {i} topic {i % 9}") for i in range(n)]
    ours.add_precomputed([Document(i, t) for i, t in docs], vecs)
    ref.add_precomputed([JaxDocument(i, t) for i, t in docs], vecs)
    assert ours._emb.shape[1] == -(-dim // 8) * 8 and ours.config.embedding_dim == dim
    np.testing.assert_array_equal(ours.embeddings.float().numpy(),
                                  np.asarray(ref.embeddings, dtype=np.float32))
    queries = [f"topic {i}" for i in range(6)]
    q = rng.normal(size=(6, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for top_k in (10, 300):
        for q_vecs, jq in ((None, None), (q, jnp.asarray(q))):
            tv, ti = ours.search_batch(queries, top_k=top_k, q_vecs=q_vecs)
            jv, ji = ref.search_batch(queries, top_k=top_k, q_vecs=jq)
            jv, ji = np.asarray(jv), np.asarray(ji)
            assert tv.shape == (6, top_k) and ti.dtype == np.int32
            np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)
            agree = tie_aware_agreement(tv, ti, jv, ji, rtol=0.0, atol=1e-6)
            assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]
    for query in queries[:3]:
        t, j = ours.search(query, top_k=5), ref.search(query, top_k=5)
        assert [x[0] for x in t] == [x[0] for x in j] and [x[2] for x in t] == [x[2] for x in j]
        np.testing.assert_allclose([x[1] for x in t], [x[1] for x in j], atol=1e-6)
    pos = rng.integers(-1, n, size=(6, 11))
    np.testing.assert_allclose(ours.score_positions_batch(queries, pos),
                               np.asarray(ref.score_positions_batch(queries, pos)), atol=1e-6)


def test_dense_dead_slots_past_the_live_rows():
    cfg = dict(embedding_dim=16, initial_capacity=64, score_block=64)
    ours = DenseIndex(embedder=Sha256Embedder(16), config=DenseIndexConfig(**cfg), device="cpu")
    ref = JaxDenseIndex(embedder=JaxSha256(16), config=JaxDenseConfig(**cfg))
    assert ours.search("x") == [] == ref.search("x")
    ours.add_documents([Document("a", "alpha"), Document("b", "beta")])
    ref.add_documents([JaxDocument("a", "alpha"), JaxDocument("b", "beta")])
    tv, ti = ours.search_batch(["alpha"], top_k=5)
    jv, ji = ref.search_batch(["alpha"], top_k=5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert np.isneginf(tv[0, 2:]).all() and (ti[0, 2:] == -1).all()


# -- HybridRetriever -------------------------------------------------------------


def test_pooled_scores_batch_matches_jax(pair):
    docs, ref, ours = pair
    queries = make_queries(docs)
    tp, tb, td = ours.pooled_scores_batch(queries, pool_size=20)
    jp, jb, jd = ref.pooled_scores_batch(queries, pool_size=20)
    same = (tp == jp).all(axis=1)
    assert same.mean() >= 0.95
    np.testing.assert_allclose(tb[same], jb[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-6)


def test_hybrid_search_matches_jax(pair):
    docs, ref, ours = pair
    same = 0
    queries = make_queries(docs)
    for query in queries:
        t, j = ours.hybrid_search(query, top_k=8), ref.hybrid_search(query, top_k=8)
        assert len(t) == len(j)
        np.testing.assert_allclose([r.hybrid_score for r in t], [r.hybrid_score for r in j],
                                   rtol=1e-4, atol=1e-5)
        same += [r.doc_id for r in t] == [r.doc_id for r in j]
    assert same >= len(queries) - 1
    tb, td, tids, ttexts = ours.get_scores_for_router(queries[0], num_passages=12)
    jb, jd, jids, jtexts = ref.get_scores_for_router(queries[0], num_passages=12)
    assert tids == jids and ttexts == jtexts and len(tb) == 12
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert ours.bm25_search(queries[0], 5) == pytest.approx(ref.bm25_search(queries[0], 5))
    assert [d for d, _ in ours.dense_search(queries[0], 5)] == \
        [d for d, _ in ref.dense_search(queries[0], 5)]


@pytest.mark.parametrize("pool_order", ["fused", "balanced"])
def test_scores_for_router_batch_matches_jax(pair, pool_order):
    docs, ref, ours = pair
    queries = make_queries(docs)
    tb, td, tids, ttexts = ours.get_scores_for_router_batch(
        queries, num_passages=10, retrieval_pool_size=20, pool_order=pool_order)
    jb, jd, jids, jtexts = ref.get_scores_for_router_batch(
        queries, num_passages=10, retrieval_pool_size=20, pool_order=pool_order)
    assert tb.shape == jb.shape == (len(queries), 10)
    same = [t == j for t, j in zip(tids, jids)]
    assert np.mean(same) >= 0.95
    rows = np.array(same)
    np.testing.assert_allclose(tb[rows], jb[rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td[rows], jd[rows], rtol=1e-5, atol=1e-6)
    assert [t for t, s in zip(ttexts, same) if s] == [j for j, s in zip(jtexts, same) if s]


def test_scores_for_router_batch_pads_and_handles_empty():
    docs = make_corpus(6, seed=3)
    ref, ours = retriever_pair(docs)
    tb, td, tids, _ = ours.get_scores_for_router_batch(["w0 w1", "zzz"], num_passages=20)
    jb, jd, jids, _ = ref.get_scores_for_router_batch(["w0 w1", "zzz"], num_passages=20)
    assert tb.shape == (2, 20) and tids == jids and tids[0][-1] == ""
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    empty_ref, empty = retriever_pair([])
    eb, ed, eids, etexts = empty.get_scores_for_router_batch(["a", "b"], num_passages=4)
    jb, _, jids, _ = empty_ref.get_scores_for_router_batch(["a", "b"], num_passages=4)
    assert eb.shape == jb.shape == (2, 4) and not eb.any() and eids == jids
    assert empty.hybrid_search("a") == [] == empty_ref.hybrid_search("a")


# -- the fused query: twotier, the live delta, a router ----------------------------


@pytest.mark.parametrize("router_kind", ["none", "recipe_v2", "clamped"])
@pytest.mark.parametrize("sparse_mode", ["twotier", "scatter"])
def test_fused_query_with_live_delta_matches_jax(router_kind, sparse_mode):
    docs = make_corpus(N_DOCS + 10, seed=29)
    ref, ours = retriever_pair(docs[:N_DOCS], bm25=dict(delta_sync_fraction=0.1))
    jr, tr = (None, None) if router_kind == "none" else routers(router_kind)
    queries = make_queries(docs)
    for approx in (False, True):
        jv, jp = ref.hybrid_search_batch(queries, router=jr, approx=approx, sparse_mode=sparse_mode)
        tv, tp = ours.hybrid_search_batch(queries, router=tr, approx=approx,
                                          sparse_mode=sparse_mode)
        assert_fused_agree(tv, tp, jv, jp)
    device, base = ours.bm25_index._device, ours.bm25_index._base["docs"]
    add(ref, ours, [(str(i), docs[i]) for i in range(N_DOCS, N_DOCS + 10)]
        + [("fresh", "zzyzx quokka w1")])
    jv, jp = ref.hybrid_search_batch(queries + ["zzyzx quokka"], router=jr,
                                     sparse_mode=sparse_mode)
    tv, tp = ours.hybrid_search_batch(queries + ["zzyzx quokka"], router=tr,
                                      sparse_mode=sparse_mode)
    assert ours.bm25_index._delta_device is not None and ref.bm25_index._delta_device is not None
    assert ours.bm25_index._device is device and ours.bm25_index._base["docs"] == base
    assert "delta_indptr" in ours._fused_state()
    assert_fused_agree(tv, tp, jv, jp)
    assert N_DOCS + 10 in tp[-1].tolist()  # the fresh doc is found through the delta


# -- RetrievalRouter ----------------------------------------------------------------


def test_router_rerank_and_decision_match_jax():
    ref, ours = routers("recipe_v2")
    rng = np.random.default_rng(4)
    bm25 = np.abs(rng.normal(3.0, 2.0, size=(5, 20))).astype(np.float32)
    dense = rng.uniform(-0.2, 0.9, size=(5, 20)).astype(np.float32)
    for k in (5, 50):
        jv, ji = ref.hybrid_rerank(bm25, dense, top_k=k)
        tv, ti = ours.hybrid_rerank(bm25, dense, top_k=k)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jd = ref.get_routing_decision(bm25, dense)
    td = ours.get_routing_decision(bm25, dense, threshold=0.5)
    assert set(td) == set(jd)
    np.testing.assert_allclose(td["routing_weights"], jd["routing_weights"], atol=1e-5)
    for key in ("avg_dense_weight", "weight_std", "dense_preferred_ratio", "bm25_preferred_ratio"):
        assert td[key] == pytest.approx(jd[key], abs=1e-5), key
    single = ours.get_routing_decision(bm25[:1, :1], dense[:1, :1])
    assert single["weight_std"] == 0.0
