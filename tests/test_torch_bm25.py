"""The port's BM25 ops against the JAX ops and the numpy Okapi oracle.

Both packages score the same synced arrays: the JAX index's device layout,
carried across with ``convert.bm25_device_state``. Tolerances: scores
within rtol 1e-6 / atol 1e-6 of the JAX ops (same f32 sums, possibly in
another order) and rtol 1e-5 of the float64 oracle; indices equal. The
two-tier op: scores within rtol 1e-5 (its high tier is a product whose f32
sums may run in another order), indices equal or, where scores tie within
1e-6, tie-aware equal. The high-tier product on the CPU is held bit for
bit to the f32 product the port took before the card's product went to the
tensor cores, and the card's call is checked for shapes on ``meta``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rag_uq_tpu.core.config import BM25Config
from rag_uq_tpu.core.types import Document
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index
from rag_uq_tpu.ops import bm25 as jax_bm25
from rag_uq_tpu.retrieval.fused import encode_for_fused as jax_encode
from rag_uq_tpu.text.tokenize import tokenize
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement
from rag_uq_tpu_torch.convert import bm25_device_state
from rag_uq_tpu_torch.ops import bm25 as torch_bm25
from rag_uq_tpu_torch.ops.topk import stable_topk
from rag_uq_tpu_torch.utils import profiling

from tests.oracles import bm25_okapi_scores, make_synthetic_corpus

QUERIES = ["w1 w2 the", "w10", "the is a", "w5 w5 w5", "unknownterm w3", ""]
NEG_QUERIES = ["c1 c2 tag0", "c3 c4 c5", "tag2 c0", "c9 c9 tag1"]

VARIANTS = {
    # name: (corpus kind, BM25Config overrides)
    "bf16": ("synthetic", dict(dense_tier_threshold=8)),
    "int8": ("synthetic", dict(impact_dtype="int8", dense_tier_threshold=8)),
    "f32_slices": ("synthetic", dict(impact_dtype="float32", dense_tier_threshold=4,
                                     low_block_budget_bytes=0)),
    "f32_negative": ("negative", dict(impact_dtype="float32", dense_tier_threshold=2)),
    "bf16_negative_slices": ("negative", dict(dense_tier_threshold=2,
                                              low_block_budget_bytes=0)),
    # A row cap raises the threshold (and the low-tier beam) to fit.
    "f32_row_cap": ("synthetic", dict(impact_dtype="float32", dense_tier_threshold=2,
                                      max_dense_tier_rows=4)),
}


def _corpus(kind):
    if kind == "negative":
        # All-doc terms dominate -> average idf < 0 -> negative weights.
        shared = " ".join(f"c{j}" for j in range(10))
        return [f"{shared} tag{i % 3}" for i in range(12)], NEG_QUERIES
    return make_synthetic_corpus(np.random.default_rng(42), n_docs=60), QUERIES


def _to_numpy(dev):
    out = {}
    for name, value in dev.items():
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            a = np.asarray(value)
            out[name] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        else:
            out[name] = value
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def synced(request):
    kind, overrides = VARIANTS[request.param]
    corpus, queries = _corpus(kind)
    idx = JaxBM25Index(config=BM25Config(**overrides))
    idx.add_documents([Document(str(i), t) for i, t in enumerate(corpus)])
    dev = idx._sync()
    impact_dtype = {"int8": torch.int8, "float32": torch.float32}.get(
        overrides.get("impact_dtype"), torch.bfloat16
    )
    state = bm25_device_state(_to_numpy(dev), impact_dtype, device="cpu")
    qterms = jax_encode(idx, queries, active_compaction=True)
    qterms = {k: torch.tensor(np.asarray(v)) for k, v in qterms.items()}
    return request.param, corpus, queries, dev, state, qterms


def test_layout_variant_is_what_it_says(synced):
    name, _, _, dev, state, _ = synced
    assert ("low_blocks" in state) == ("slices" not in name)
    assert dev["nonneg"] == ("negative" not in name)


def test_score_all_and_topk_from_scores_match(synced):
    _, _, _, dev, state, qterms = synced
    ncap = state["n_docs_cap"]
    js = jax_bm25.score_all(dev["indptr"], dev["post_doc"], dev["post_w"],
                            jnp.asarray(qterms["qtids"].numpy()), ncap, dev["max_df"])
    ts = torch_bm25.score_all(state["indptr"], state["post_doc"], state["post_w"],
                              qterms["qtids"], ncap, state["max_df"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    jv, ji = jax_bm25.topk_from_scores(js, 7)
    tv, ti = torch_bm25.topk_from_scores(ts, 7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_score_all_matches_okapi_oracle(synced):
    _, corpus, queries, _, state, qterms = synced
    ts = torch_bm25.score_all(state["indptr"], state["post_doc"], state["post_w"],
                              qterms["qtids"], state["n_docs_cap"], state["max_df"])
    toks = [tokenize(t) for t in corpus]
    for i, q in enumerate(queries):
        expect = bm25_okapi_scores(toks, tokenize(q))
        np.testing.assert_allclose(ts[i, : len(corpus)].numpy(), expect, rtol=1e-5, atol=1e-6)


def test_score_docs_matches(synced):
    _, corpus, _, dev, state, qterms = synced
    rng = np.random.default_rng(0)
    pos = rng.integers(-1, len(corpus), size=(qterms["qtids"].shape[0], 9)).astype(np.int32)
    js = jax_bm25.score_docs(dev["indptr"], dev["post_doc"], dev["post_w"],
                             jnp.asarray(qterms["qtids"].numpy()), jnp.asarray(pos))
    ts = torch_bm25.score_docs(state["indptr"], state["post_doc"], state["post_w"],
                               qterms["qtids"], torch.from_numpy(pos))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compact", [False, True])
def test_topk_lowscatter_matches(synced, compact):
    _, _, _, dev, state, qterms = synced
    extra_j, extra_t = {}, {}
    if compact:
        for name in ("active_rows", "rows_compact"):
            extra_j[name] = jnp.asarray(qterms[name].numpy())
            extra_t[name] = qterms[name]
    for name in ("low_blocks", "low_row"):
        if name in state:
            extra_j[name] = dev[name]
            extra_t[name] = state[name]
    k = 7
    jv, ji = jax_bm25.topk_lowscatter(
        dev["low_ranges"], dev["post_packed"], dev["term_row"], dev["impact"],
        jnp.asarray(qterms["qtids_base"].numpy()), k, beam=dev["beam"],
        approx=False, impact_scale=dev["impact_scale"], **extra_j,
    )
    tv, ti = torch_bm25.topk_lowscatter(
        state["low_ranges"], state["post_packed"], state["term_row"],
        state["impact"], qterms["qtids_base"], k, beam=state["beam"],
        approx=False, impact_scale=state["impact_scale"], **extra_t,
    )
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_lowscatter_exact_against_score_all_f32():
    """With f32 impacts the scatter-mode op equals the exhaustive oracle."""
    corpus, queries = _corpus("synthetic")
    idx = JaxBM25Index(config=BM25Config(impact_dtype="float32", dense_tier_threshold=8))
    idx.add_documents([Document(str(i), t) for i, t in enumerate(corpus)])
    state = bm25_device_state(_to_numpy(idx._sync()), torch.float32, device="cpu")
    qtids = torch.from_numpy(idx.encode_queries(queries))
    ev, ei = torch_bm25.topk_from_scores(
        torch_bm25.score_all(state["indptr"], state["post_doc"], state["post_w"],
                             qtids, state["n_docs_cap"], state["max_df"]), 5)
    fv, fi = torch_bm25.topk_lowscatter(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qtids, 5, beam=state["beam"], impact_scale=state["impact_scale"],
        low_blocks=state["low_blocks"], low_row=state["low_row"],
    )
    live = ev > 0
    np.testing.assert_allclose(fv[live].numpy(), ev[live].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(fi[live].numpy(), ei[live].numpy())


@pytest.mark.parametrize("lsel", [0, 16])
def test_topk_twotier_matches(synced, lsel):
    """Every variant (bf16, int8, f32, a row cap, the nonneg=False scatter
    fallback), repeated query terms ("w5 w5 w5"), with and without lsel."""
    _, _, _, dev, state, qterms = synced
    k = 7
    jv, ji = jax_bm25.topk_twotier(
        dev["low_ranges"], dev["post_packed"], dev["term_row"], dev["impact"],
        jnp.asarray(qterms["qtids_base"].numpy()), k, beam=dev["beam"], approx=False,
        lsel=lsel, impact_scale=dev["impact_scale"], nonneg=dev["nonneg"],
    )
    tv, ti = torch_bm25.topk_twotier(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qterms["qtids_base"], k, beam=state["beam"], approx=False, lsel=lsel,
        impact_scale=state["impact_scale"], nonneg=state["nonneg"],
    )
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)
    agree = tie_aware_agreement(tv.numpy(), ti.numpy(), jv, ji, rtol=0.0, atol=1e-6)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]


def test_twotier_row_cap_raises_threshold_stays_exact():
    """The capped tier reroutes terms to a wider low-tier beam and the op
    still equals the exhaustive oracle (f32 impacts)."""
    corpus, queries = _corpus("synthetic")
    idx = JaxBM25Index(config=BM25Config(impact_dtype="float32", dense_tier_threshold=2,
                                         max_dense_tier_rows=4))
    idx.add_documents([Document(str(i), t) for i, t in enumerate(corpus)])
    state = bm25_device_state(_to_numpy(idx._sync()), torch.float32, device="cpu")
    assert state["impact"].shape[0] <= 8 and state["beam"] > 8
    qtids = torch.from_numpy(idx.encode_queries(queries))
    ev, ei = torch_bm25.topk_from_scores(
        torch_bm25.score_all(state["indptr"], state["post_doc"], state["post_w"],
                             qtids, state["n_docs_cap"], state["max_df"]), 5)
    fv, fi = torch_bm25.topk_twotier(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qtids, 5, beam=state["beam"], impact_scale=state["impact_scale"],
    )
    live = ev > 0
    np.testing.assert_allclose(fv[live].numpy(), ev[live].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(fi[live].numpy(), ei[live].numpy())


# -- the high-tier product: the CPU's f32 product unchanged, the card's call --------------

def _f32_high_tier(impact, qtids, term_row, impact_scale=None, rows_compact=None, out=None):
    """``high_tier`` as the port took it on every device before the card's
    product went to the tensor cores: a ``[B, t + 1]`` one-hot, an
    out-of-place scale, both operands widened to f32."""
    t, nq = impact.shape[0], qtids.shape[0]
    onehot_dtype = torch.bfloat16 if impact.dtype == torch.int8 else impact.dtype
    if rows_compact is not None:
        slot, scale = rows_compact, None
        weight = (impact_scale[rows_compact.clamp(min=0).long()] if impact_scale is not None
                  else torch.ones(slot.shape, dtype=torch.float32))
    else:
        valid = qtids >= 0
        slot = torch.where(valid, term_row[torch.where(valid, qtids, 0).long()], -1)
        weight, scale = torch.ones(slot.shape, dtype=onehot_dtype), impact_scale
    col = torch.where(slot >= 0, slot, t).long()
    onehot = torch.zeros((nq, t + 1), dtype=onehot_dtype)
    b_ix = torch.arange(nq)[:, None]
    onehot.index_put_((b_ix.expand_as(col), col), weight.to(onehot_dtype), accumulate=True)
    onehot = onehot[:, :t]
    if scale is not None:
        onehot = onehot * scale.to(onehot_dtype)[None, :]
    return torch.matmul(onehot.float(), impact.to(onehot_dtype).float(), out=out)


def _f32_lowscatter(state, qterms, k, compact):
    """``topk_lowscatter`` as it was: ``[B, N + 1]`` totals, ``_f32_high_tier``."""
    impact, scale, qtids = state["impact"], state["impact_scale"], qterms["qtids_base"]
    ncap, nq = impact.shape[1], qtids.shape[0]
    total = torch.zeros((nq, ncap + 1), dtype=torch.float32)
    if compact:
        rows = qterms["active_rows"].long()
        _f32_high_tier(impact[rows], qtids, state["term_row"], scale[rows],
                       rows_compact=qterms["rows_compact"], out=total[:, :ncap])
    else:
        _f32_high_tier(impact, qtids, state["term_row"], scale, out=total[:, :ncap])
    if "low_blocks" in state:
        docs, w = torch_bm25.block_postings(state["low_blocks"], state["low_row"], qtids)
    else:
        docs, w, ok = torch_bm25.posting_slices(state["low_ranges"], state["post_packed"],
                                                qtids, state["beam"])
        docs = torch.where(ok, docs, 0).reshape(nq, -1)
        w = torch.where(ok, w, 0.0).reshape(nq, -1)
    total.scatter_add_(1, docs.long(), w)
    vals, idx = stable_topk(total[:, :ncap], k)
    return vals, idx.to(torch.int32)


def _assert_bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                       b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("compact", [False, True])
def test_high_tier_on_the_cpu_is_the_f32_product_bit_for_bit(synced, compact):
    """Every variant (bf16, int8 with its row scales, f32), with and without
    the active-row compaction, fresh and into the scatter pool's totals."""
    _, _, _, _, state, qterms = synced
    impact, scale, term_row = state["impact"], state["impact_scale"], state["term_row"]
    qtids = qterms["qtids_base"]
    kw = {}
    if compact:
        rows = qterms["active_rows"].long()
        impact, scale = impact[rows], scale[rows]
        kw["rows_compact"] = qterms["rows_compact"]
    _assert_bitwise(torch_bm25.high_tier(impact, qtids, term_row, scale, **kw),
                    _f32_high_tier(impact, qtids, term_row, scale, **kw))
    n = impact.shape[1]
    total = torch_bm25.scatter_totals(qtids.shape[0], n, "cpu")
    old = torch.zeros((qtids.shape[0], n + 1))
    torch_bm25.high_tier(impact, qtids, term_row, scale, out=total[:, :n], **kw)
    _f32_high_tier(impact, qtids, term_row, scale, out=old[:, :n], **kw)
    _assert_bitwise(total[:, :n], old[:, :n])
    assert not total[:, n:].any()


@pytest.mark.parametrize("compact", [False, True])
def test_topk_lowscatter_is_unchanged_by_the_padded_totals(synced, compact):
    """The totals' rows grew from N + 1 to N + 4 floats; the pool's scores
    and docs are bit for bit those over N + 1 (the spare column dropped)."""
    _, _, _, _, state, qterms = synced
    extra = {name: state[name] for name in ("low_blocks", "low_row") if name in state}
    if compact:
        extra.update(active_rows=qterms["active_rows"], rows_compact=qterms["rows_compact"])
    k = state["n_docs_cap"]  # every doc, so the padding's spare column would show
    tv, ti = torch_bm25.topk_lowscatter(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qterms["qtids_base"], k, beam=state["beam"], impact_scale=state["impact_scale"],
        **extra)
    ov, oi = _f32_lowscatter(state, qterms, k, compact)
    _assert_bitwise(tv, ov)
    _assert_bitwise(ti, oi)


def test_the_cpu_takes_no_tensor_core_product(synced):
    _, _, _, _, state, qterms = synced
    profiling.enable()
    try:
        profiling.take()
        torch_bm25.topk_lowscatter(
            state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
            qterms["qtids_base"], 5, beam=state["beam"], impact_scale=state["impact_scale"],
            active_rows=qterms["active_rows"], rows_compact=qterms["rows_compact"])
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    assert counters.get("bm25.high_product_tc", 0) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,t,n", [(2048, 4096, 65536), (32, 64, 1024), (5, 13, 1000)])
def test_the_cards_product_call_is_accepted_on_meta(dtype, b, t, n):
    """The card's route: ``mm`` of the 16-bit one-hot, laid out as
    ``high_tier`` lays it out, with the impact rows, ``out_dtype`` f32, into
    the scatter pool's totals, gives the [B, N] f32 view with no copy."""
    impact = torch.zeros((t, n), dtype=dtype, device="meta")
    qtids = torch.zeros((b, 32), dtype=torch.int32, device="meta")
    term_row = torch.zeros(1024, dtype=torch.int32, device="meta")
    onehot = torch_bm25.high_onehot(impact, qtids, term_row)
    assert onehot.shape == (b, t) and onehot.dtype == dtype
    assert onehot.stride(0) % 8 == 0 and onehot.stride(0) > t
    compact = torch_bm25.high_onehot(impact, qtids, term_row, rows_compact=qtids)
    assert compact.shape == (b, t) and compact.stride() == onehot.stride()
    total = torch_bm25.scatter_totals(b, n, "meta")
    assert total.shape == (b, n + 4) and total.stride(0) % 4 == 0
    out = total[:, :n]
    got = torch.mm(onehot, impact, out_dtype=torch.float32, out=out)
    assert got.shape == (b, n) and got.dtype == torch.float32
    assert got.stride() == (n + 4, 1)
    fresh = torch.mm(onehot, impact, out_dtype=torch.float32)
    assert fresh.shape == (b, n) and fresh.dtype == torch.float32
