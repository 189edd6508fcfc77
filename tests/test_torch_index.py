"""The port's indices against the JAX package's: every array of the BM25
two-tier device layout equal as numpy (exact), and the dense matrix equal
after growth and padded appends (exact: both round the same f32 vectors to
bf16)."""

import os
import tempfile

import numpy as np
import pytest
import torch

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.core.config import BM25Config as JaxBM25Config  # noqa: E402
from rag_uq_tpu.core.config import DenseIndexConfig as JaxDenseConfig  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import Sha256Embedder as JaxSha256  # noqa: E402
from rag_uq_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index  # noqa: E402
from rag_uq_tpu.retrieval.fused import encode_for_fused as jax_encode  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import Sha256Embedder  # noqa: E402
from rag_uq_tpu_torch.index.dense import DenseIndex  # noqa: E402
from rag_uq_tpu_torch.index.sparse import BM25Index  # noqa: E402
from rag_uq_tpu_torch.retrieval.fused import encode_for_fused  # noqa: E402

from tests.oracles import make_synthetic_corpus  # noqa: E402

CONFIGS = {
    "default": {},
    "bf16_low_tier": dict(dense_tier_threshold=8),
    "int8": dict(impact_dtype="int8", dense_tier_threshold=4),
    "f32_row_cap": dict(impact_dtype="float32", dense_tier_threshold=2, max_dense_tier_rows=8),
    "no_blocks": dict(dense_tier_threshold=4, low_block_budget_bytes=0),
}
QUERIES = ["w1 w2 the", "the is a of", "w5 w5 w5", "unknownterm w3", ""]


def _np(x):
    """numpy view of a torch tensor or a JAX array; bf16 as f32 values."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sync_layout_matches_jax(name):
    texts = make_synthetic_corpus(np.random.default_rng(11), 90)
    ours = BM25Index(config=BM25Config(**CONFIGS[name]), device="cpu")
    ref = JaxBM25Index(config=JaxBM25Config(**CONFIGS[name]))
    # Two batches: the sync covers incremental adds.
    for lo, hi in ((0, 50), (50, 90)):
        ours.add_documents([Document(str(i), texts[i]) for i in range(lo, hi)])
        ref.add_documents([JaxDocument(str(i), texts[i]) for i in range(lo, hi)])
    a, b = ours._sync(), ref._sync()
    assert set(a) == set(b)
    for key, value in b.items():
        if hasattr(value, "shape"):
            np.testing.assert_array_equal(_np(a[key]), _np(value), err_msg=key)
            assert a[key].device.type == "cpu"
        else:
            assert a[key] == value, key
    np.testing.assert_array_equal(ours._term_row_host, ref._term_row_host)
    ta, tb = encode_for_fused(ours, QUERIES, True), jax_encode(ref, QUERIES, True)
    assert set(ta) == set(tb)
    for key in tb:
        np.testing.assert_array_equal(ta[key].numpy(), np.asarray(tb[key]), err_msg=key)


def test_sync_is_lazy_and_bumps_generation():
    idx = BM25Index(device="cpu")
    idx.add_documents([Document("a", "x y"), Document("b", "y z")])
    first = idx._sync()
    assert idx._sync() is first and idx.sync_generation == 1
    idx.add_documents([Document("c", "z w")])
    assert idx._sync() is not first and idx.sync_generation == 2


def test_delta_sync_is_not_ported_yet():
    """Once a refusal, now a parity check: with delta_sync_fraction > 0 a
    search after a small ingest serves from the base plus a delta, as the
    JAX index does, with the same results (scores within rtol 1e-5)."""
    texts = make_synthetic_corpus(np.random.default_rng(2), 44)
    cfg = dict(delta_sync_fraction=0.1, dense_tier_threshold=8)
    ours = BM25Index(config=BM25Config(**cfg), device="cpu")
    ref = JaxBM25Index(config=JaxBM25Config(**cfg))
    for lo, hi in ((0, 40), (40, 44)):
        ours.add_documents([Document(str(i), texts[i]) for i in range(lo, hi)])
        ref.add_documents([JaxDocument(str(i), texts[i]) for i in range(lo, hi)])
        tv, ti = ours.search_batch(QUERIES, top_k=5, exact=False)
        jv, ji = ref.search_batch(QUERIES, top_k=5, exact=False)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ti, ji)
    assert ours._delta_device is not None and ours._base["docs"] == 40


def test_dense_growth_and_padding_match_jax():
    texts = [f"passage {i} about topic {i % 7}" for i in range(40)]
    cfg = dict(embedding_dim=32, initial_capacity=16, score_block=16)
    ours = DenseIndex(embedder=Sha256Embedder(32), config=DenseIndexConfig(**cfg), device="cpu")
    ref = JaxDenseIndex(embedder=JaxSha256(32), config=JaxDenseConfig(**cfg))
    for lo, hi in ((0, 10), (10, 33), (5, 40)):  # overlaps dedup by id
        n_ours = ours.add_documents([Document(str(i), texts[i]) for i in range(lo, hi)], batch_size=8)
        n_ref = ref.add_documents([JaxDocument(str(i), texts[i]) for i in range(lo, hi)], batch_size=8)
        assert n_ours == n_ref
        assert ours.capacity == ref.capacity and len(ours) == len(ref)
        np.testing.assert_array_equal(_np(ours._emb), _np(ref._emb))
    assert ours.capacity > 16 and ours._emb.dtype == torch.bfloat16
    assert ours.store.ids == ref.store.ids
    q = ["topic 3", "passage 9"]
    np.testing.assert_allclose(ours.embed_queries(q).numpy(), np.asarray(ref.embed_queries(q)), atol=1e-7)


def test_dense_add_precomputed_matches_jax():
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(20, 16)).astype(np.float32)
    cfg = dict(embedding_dim=16, initial_capacity=8, score_block=8)
    ours = DenseIndex(embedder=Sha256Embedder(16), config=DenseIndexConfig(**cfg), device="cpu")
    ref = JaxDenseIndex(embedder=JaxSha256(16), config=JaxDenseConfig(**cfg))
    for lo, hi in ((0, 12), (6, 20)):
        ours.add_precomputed([Document(str(i), "") for i in range(lo, hi)], vecs[lo:hi])
        ref.add_precomputed([JaxDocument(str(i), "") for i in range(lo, hi)], vecs[lo:hi])
    assert len(ours) == len(ref) == 20 and ours.capacity == ref.capacity
    np.testing.assert_array_equal(_np(ours._emb), _np(ref._emb))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BM25Index()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseIndex(embedder=Sha256Embedder(16))
