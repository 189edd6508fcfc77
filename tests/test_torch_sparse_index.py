"""The port's ``BM25Index`` queries and its main+delta sync against the JAX
index after the same ingest sequence (``device="cpu"``).

Tolerances: the exhaustive paths (``score_all_batch``, ``search_batch``
with ``exact=True``, ``score_positions_batch``) within rtol 1e-6 / atol
1e-6 with equal indices (the same f32 sums, possibly in another order); the
two-tier path within rtol 1e-5, indices tie-aware within 1e-6 (its
high-tier product may sum in another order); the delta's frozen-statistics
scores within 1e-4 of a float64 oracle, as the JAX test holds them.
"""

import collections
import os
import tempfile

import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.core.config import BM25Config as JaxBM25Config  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.index.sparse import BM25Index, build_delta_csr  # noqa: E402

from tests.oracles import make_synthetic_corpus  # noqa: E402

QUERIES = ["w1 w2 the", "w10 w3", "the is a", "w5 w5 unknownterm", "", "zzznovel w1"]
CONFIGS = {
    "bf16": dict(dense_tier_threshold=8),
    "int8": dict(impact_dtype="int8", dense_tier_threshold=8),
    "f32_row_cap": dict(impact_dtype="float32", dense_tier_threshold=2, max_dense_tier_rows=4),
}


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_corpus(np.random.default_rng(5), n_docs=60)


def _pair(cfg, docs, **jax_kw):
    ours = BM25Index(config=BM25Config(**cfg), device="cpu")
    ref = JaxBM25Index(config=JaxBM25Config(**cfg), **jax_kw)
    add(ours, ref, docs)
    return ours, ref


def add(ours, ref, docs):
    ours.add_documents([Document(i, t) for i, t in docs])
    ref.add_documents([JaxDocument(i, t) for i, t in docs])


def assert_topk_agree(tv, ti, jv, ji, rtol):
    assert tv.shape == jv.shape and ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-6)
    agree = tie_aware_agreement(tv, ti, jv, ji, rtol=0.0, atol=1e-6)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_queries_match_jax(corpus, name):
    ours, ref = _pair(CONFIGS[name], [(str(i), t) for i, t in enumerate(corpus)])
    np.testing.assert_allclose(ours.score_all_batch(QUERIES), ref.score_all_batch(QUERIES),
                               rtol=1e-6, atol=1e-6)
    tv, ti = ours.search_batch(QUERIES, top_k=7, exact=True)
    jv, ji = ref.search_batch(QUERIES, top_k=7, exact=True)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    for approx in (False, True):
        tv, ti = ours.search_batch(QUERIES, top_k=7, exact=False, approx=approx)
        jv, ji = ref.search_batch(QUERIES, top_k=7, exact=False, approx=approx)
        assert tv.dtype == np.float32 and ti.dtype == np.int32
        assert_topk_agree(tv, ti, jv, ji, rtol=1e-5)
    pos = np.random.default_rng(1).integers(-1, len(corpus), size=(len(QUERIES), 9))
    np.testing.assert_allclose(ours.score_positions_batch(QUERIES, pos),
                               ref.score_positions_batch(QUERIES, pos), rtol=1e-6, atol=1e-6)
    for q in QUERIES:
        t, j = ours.search(q, top_k=5), ref.search(q, top_k=5)
        assert [d for d, _ in t] == [d for d, _ in j]
        np.testing.assert_allclose([s for _, s in t], [s for _, s in j], rtol=1e-5)
    assert ours.get_document("3").text == ref.get_document("3").text
    assert ours.get_document("missing") is None


def test_empty_index_searches():
    ours = BM25Index(device="cpu")
    assert ours.search("anything") == [] and len(ours) == 0


def test_negative_weights_take_the_scatter_fallback():
    shared = " ".join(f"c{j}" for j in range(10))
    docs = [(str(i), f"{shared} tag{i % 3}") for i in range(12)]
    ours, ref = _pair(dict(impact_dtype="float32", dense_tier_threshold=2), docs)
    assert not ours._sync()["nonneg"]
    queries = ["c1 c2 tag0", "c3 c4 c5", "tag2 c0"]
    tv, ti = ours.search_batch(queries, top_k=3, exact=False)
    jv, ji = ref.search_batch(queries, top_k=3, exact=False)
    assert_topk_agree(tv, ti, jv, ji, rtol=1e-5)
    ev, ei = ours.search_batch(queries, top_k=3, exact=True)
    live = ev > 0
    np.testing.assert_allclose(tv[live], ev[live], rtol=1e-5)


def _delta_pair(corpus, frac=0.5, n_base=40):
    cfg = dict(delta_sync_fraction=frac, impact_dtype="float32", dense_tier_threshold=8)
    ours, ref = _pair(cfg, [(str(i), corpus[i]) for i in range(n_base)])
    ours.search_batch(["w1"], top_k=3, exact=False)  # base sync
    ref.search_batch(["w1"], top_k=3, exact=False)
    return ours, ref


def test_delta_serves_without_full_resync(corpus):
    ours, ref = _delta_pair(corpus)
    gen, device, base_docs = ours.sync_generation, ours._device, ours._base["docs"]
    new = [(str(i), corpus[i]) for i in range(40, 50)] + [("new1", "zzznovel qqqterm w1")]
    add(ours, ref, new)
    tv, ti = ours.search_batch(QUERIES, top_k=10, exact=False)
    jv, ji = ref.search_batch(QUERIES, top_k=10, exact=False)
    assert ours._delta_device is not None and ref._delta_device is not None
    assert ours._device is device and ours._base["docs"] == base_docs == 40
    assert ours.sync_generation == gen + 1  # the delta build, not a full sync
    assert_topk_agree(tv, ti, jv, ji, rtol=1e-5)
    # New delta terms are searchable: "zzznovel" only exists in doc 50.
    assert ti[-1][0] == 50
    # The same delta arrays as the JAX index, exactly.
    for key in ("indptr", "post_doc", "post_w"):
        np.testing.assert_array_equal(ours._delta_device[key].numpy(),
                                      np.asarray(ref._delta_device[key]), err_msg=key)
    for key in ("n_docs_cap", "max_df", "base_docs"):
        assert ours._delta_device[key] == ref._delta_device[key], key


def test_delta_staleness_is_frozen_stats_exactly(corpus):
    ours, _ = _delta_pair(corpus)
    base_v, base_i = ours.search_batch(["w1 w2 the"], top_k=40, exact=False)
    delta_texts = ["w1 w2 zznew", "the w3 w3 w3", "w2 w2 of is"]
    ours.add_documents([Document(f"d{i}", t) for i, t in enumerate(delta_texts)])
    v, i = ours.search_batch(["w1 w2 the"], top_k=43, exact=False)
    assert ours._delta_device is not None
    scores = {int(p): float(s) for s, p in zip(v[0], i[0]) if p >= 0}
    for s, p in zip(base_v[0], base_i[0]):
        if p >= 0:
            assert abs(scores.get(int(p), 0.0) - s) < 1e-5
    base_tokens = [corpus[j].split() for j in range(40)]
    avgdl = np.mean([len(t) for t in base_tokens])
    df = collections.Counter(w for t in base_tokens for w in set(t))
    n = len(base_tokens)
    idf = {w: np.log(n - d + 0.5) - np.log(d + 0.5) for w, d in df.items()}
    avg_idf = sum(idf.values()) / len(idf)
    idf = {w: (0.25 * avg_idf if x < 0 else x) for w, x in idf.items()}
    for j, text in enumerate(delta_texts):
        toks = text.split()
        tf = collections.Counter(toks)
        expect = sum(
            idf.get(q, 0.0) * tf.get(q, 0) * 2.5
            / (tf.get(q, 0) + 1.5 * (1 - 0.75 + 0.75 * len(toks) / avgdl))
            for q in "w1 w2 the".split()
        )
        assert abs(scores.get(40 + j, 0.0) - expect) < 1e-4, (j, expect)


def test_delta_vocab_grows_past_base_capacity():
    cfg = dict(delta_sync_fraction=0.5, impact_dtype="float32", dense_tier_threshold=8)
    docs = [(str(i), " ".join(f"t{i}x{j}" for j in range(32))) for i in range(32)]
    ours, ref = _pair(cfg, docs)
    ours.search_batch(["t0x0"], top_k=3, exact=False)
    ref.search_batch(["t0x0"], top_k=3, exact=False)
    assert len(ours.vocab) == 1024
    add(ours, ref, [("new", "zzzfresh t0x0")])
    tv, ti = ours.search_batch(["zzzfresh", "t0x0"], top_k=3, exact=False)
    jv, ji = ref.search_batch(["zzzfresh", "t0x0"], top_k=3, exact=False)
    assert ours._delta_device is not None and ours._delta_device["indptr"].shape[0] > 1025
    assert 32 in ti[0][ti[0] >= 0].tolist()
    assert_topk_agree(tv, ti, jv, ji, rtol=1e-5)


def test_fraction_exceeded_triggers_full_sync(corpus):
    ours, _ = _delta_pair(corpus, frac=0.1)
    ours.add_documents([Document(str(i), corpus[i % 60] + f" x{i}") for i in range(40, 60)])
    ours.search_batch(["w1"], top_k=3, exact=False)
    assert ours._delta_device is None and ours._base["docs"] == 60


def test_require_full_sync_collapses_the_delta(corpus):
    ours, ref = _delta_pair(corpus)
    add(ours, ref, [("n1", "w1 w2 fresh")])
    ours.search_batch(["w1"], top_k=3, exact=False)
    assert ours._delta_device is not None
    ev, ei = ours.search_batch(["w1", "fresh"], top_k=3, exact=True)
    assert ours._delta_device is None and ours._base["docs"] == 41
    jv, ji = ref.search_batch(["w1", "fresh"], top_k=3, exact=True)
    np.testing.assert_allclose(ev, np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(ei, np.asarray(ji))


def test_build_delta_csr_matches_jax():
    from rag_uq_tpu.index.sparse import build_delta_csr as jax_build_delta_csr

    rng = np.random.default_rng(3)
    tid = rng.integers(0, 30, size=200).astype(np.int32)
    doc = np.sort(rng.integers(100, 140, size=200)).astype(np.int32)
    tf = rng.integers(1, 4, size=200).astype(np.int32)
    doc_lens = rng.integers(5, 30, size=140).tolist()
    base = {"docs": 100, "idf": rng.normal(1.0, 0.5, size=20), "eps": 0.07, "avgdl": 14.5}
    a = build_delta_csr(tid, doc, tf, doc_lens, 30, base, 1.5, 0.75, 40)
    b = jax_build_delta_csr(tid, doc, tf, doc_lens, 30, base, 1.5, 0.75, 40)
    assert set(a) == set(b)
    for key, value in b.items():
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(value), err_msg=key)
