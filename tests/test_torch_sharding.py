"""The port's corpus sharding (``rag_uq_tpu_torch/parallel/sharding.py``)
against the JAX package's (``rag_uq_tpu/parallel/sharding.py``), mirroring
``tests/test_sharding.py``.

The same numpy inputs (made from seeds, the corpus and the live-ingest
delta laid out by the JAX ``ShardedHybridIndex``) go through both packages
at S = 2, 4 and 8 shards: JAX's ``make_mesh(S)`` takes the first S of the 8
virtual CPU devices, and the port runs its S shards in this process through
the per-shard bodies and the merge (``run_in_process``). The layout depends
on S (``shard_cap``), so the two are compared at the same S.

- ``bm25_state_layout`` and ``bm25_twotier_layout`` equal JAX's
  ``shard_bm25_state`` and ``shard_bm25_twotier`` bit for bit (bf16 impacts
  included, rounded from f32 to nearest even without ``ml_dtypes``).
- Dense top-k (partial occupancy, a pool larger than a shard): scores
  within 1e-6 (f32 sums in another order), indices under the tie rule.
- Exhaustive BM25 top-k: live scores within rtol 1e-5, live indices equal.
- The fused query in both sparse modes, with and without the router and
  the replicated delta: under the tie rule with rank-wise scores within
  rtol 1e-4 / atol 1e-5, and at least 99% of queries identical position by
  position (the tolerance of the single-device port tests).
- Two spawned gloo groups, four ranks and a two-rank sub-mesh of them (one
  launch, ``tests/test_torch_spawn.py::sharding_program``), give the
  in-process results at S = 4 and 2 bit for bit.
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
from rag_uq_tpu.core.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxNgram  # noqa: E402
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index  # noqa: E402
from rag_uq_tpu.parallel import sharding as jax_sharding  # noqa: E402
from rag_uq_tpu.parallel.sharded_index import ShardedHybridIndex as JaxSharded  # noqa: E402
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config  # noqa: E402
from rag_uq_tpu_torch.core.mesh import _spawn_ranks  # noqa: E402
from rag_uq_tpu_torch.parallel.sharding import (  # noqa: E402
    bm25_state_layout,
    bm25_twotier_layout,
    merge_shard_pools,
)

from tests.oracles import make_synthetic_corpus  # noqa: E402
from tests.test_torch_spawn import (  # noqa: E402
    DENSE_BLOCK,
    DENSE_CASES,
    FUSED_CASES,
    FUSED_K,
    FUSED_POOL,
    fused_shard_cap,
    sharding_program,
    sharding_results,
)

SHARDS = (2, 4, 8)
SPAWNED = 4  # ranks; the sub-mesh takes two of them
# The fused cases JAX compiles at each S (every case runs at every S in the port).
JAX_FUSED = {2: (0, 3), 4: (1, 2), 8: (0, 1, 2, 3)}


def _queries(docs, n=20, seed=5):
    rng = np.random.default_rng(seed)
    out = ["w1 w2 the", "w10 w3", "the is a w5", "w7", "zzuniquetoken w1"]
    for i in rng.integers(0, len(docs), size=n):
        toks = docs[i].split()
        out.append(" ".join(rng.choice(toks, size=min(3, len(toks)), replace=False)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(1024, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.normal(size=(5, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    bm25_docs = make_synthetic_corpus(np.random.default_rng(7), 100)
    bm25 = JaxBM25Index()
    bm25.add_documents([JaxDocument(str(i), t) for i, t in enumerate(bm25_docs)])
    dev = bm25._sync()
    bm25_in = {name: np.asarray(dev[name]) for name in ("indptr", "post_doc", "post_w")}
    bm25_in.update(n_docs_cap=int(dev["n_docs_cap"]), max_df=int(dev["max_df"]),
                   qtids=bm25.encode_queries(["w1 w2 the", "w10 w3", "the is a w5"]))

    # The fused query's inputs: 280 base docs and a delta of 16 more (with a
    # term no base doc has), laid out by the JAX index.
    docs = make_synthetic_corpus(np.random.default_rng(21), 300)
    docs[290] = "zzuniquetoken zzuniquetoken w1 " + docs[290]
    jidx = JaxSharded(jax_make_mesh(8), embedder=JaxNgram(dim=64, buckets=4096),
                      bm25_config=JaxBM25Config(delta_sync_fraction=0.25),
                      dense_config=JaxDenseConfig(embedding_dim=64))
    jidx.add_documents([JaxDocument(str(i), t) for i, t in enumerate(docs[:280])])
    jidx.sync()
    csr = jidx.bm25.host_csr()
    jidx.add_documents([JaxDocument(str(i), t) for i, t in enumerate(docs[280:296], 280)])
    delta = jidx.sync()["delta"]
    queries = _queries(docs)
    vecs = np.array(jidx.embedder.encode(queries), dtype=np.float32)
    vecs /= np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
    router = JaxRouter(seed=2)
    fused = {
        "csr": {name: np.asarray(csr[name]) for name in ("tid", "doc", "w", "df")},
        "emb": np.concatenate(jidx._host_emb).astype(np.float32),
        "emb_dtype": "bfloat16",
        "impact_dtype": "bfloat16",
        "q": vecs.astype(np.float32),
        "qtids": jidx.bm25.encode_queries(queries),
        "base_docs": 280,
        "n_docs": 296,
        "delta": {"emb": np.asarray(delta["emb"], dtype=np.float32),
                  **{name: np.asarray(delta[name]) for name in ("indptr", "post_doc", "post_w")},
                  "n_docs_cap": int(delta["n_docs_cap"]), "max_df": int(delta["max_df"])},
        "router_params": _np(router.params),
        "router_stats": _np(router.stats),
    }
    return {"dense_emb": emb, "dense_q": q, "bm25": bm25_in, "fused": fused,
            "jax_router": router}


def _portable(inputs):
    return {k: v for k, v in inputs.items() if k != "jax_router"}


@pytest.fixture(scope="module")
def port(inputs):
    """The port's results at every S, in this process, on one thread (as
    the spawned ranks run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {s: sharding_results(_portable(inputs), s) for s in SHARDS}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_ranks")
    _spawn_ranks(sharding_program, SPAWNED, (_portable(inputs), str(out)))
    return {s: dict(np.load(out / f"sharding_{s}.npz")) for s in (2, SPAWNED)}


def _assert_agree(tv, tp, jv, jp, rtol=1e-4, atol=1e-5, raw_min=0.99):
    agree = tie_aware_agreement(tv, tp, np.asarray(jv), np.asarray(jp), rtol=rtol, atol=atol)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]
    assert agree["raw_idx_agreement"] >= raw_min, agree


# -- layouts ----------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
def test_bm25_state_layout_equals_jax(inputs, n_shards):
    b = inputs["bm25"]
    state = {"indptr": b["indptr"], "post_doc": b["post_doc"], "post_w": b["post_w"],
             "docs_per_shard": b["n_docs_cap"] // n_shards}
    ours = bm25_state_layout(state, n_shards)
    ref = jax_sharding.shard_bm25_state(state, jax_make_mesh(n_shards))
    for name in ("indptr", "post_doc", "post_w"):
        np.testing.assert_array_equal(ours[name], np.asarray(ref[name]))
    odd = bm25_state_layout(state, n_shards, shards=[n_shards - 1, 0])
    np.testing.assert_array_equal(odd["post_doc"][0], ours["post_doc"][n_shards - 1])


@pytest.mark.parametrize("n_shards,impact_dtype,tight", [
    (s, d, False) for s in SHARDS for d in ("bfloat16", "int8", "float32")
] + [(8, "bfloat16", True)])
def test_twotier_layout_equals_jax_bit_for_bit(inputs, n_shards, impact_dtype, tight):
    f = inputs["fused"]
    shard_cap = fused_shard_cap(f["base_docs"], n_shards)
    # tight: a low threshold under a budget of 8 rows, so the threshold rises.
    knobs = dict(dense_tier_threshold=4, impact_budget_bytes=8 * shard_cap * 2) if tight else {}
    ours = bm25_twotier_layout(f["csr"], n_shards, shard_cap,
                               BM25Config(impact_dtype=impact_dtype, **knobs))
    ref = jax_sharding.shard_bm25_twotier(f["csr"], jax_make_mesh(n_shards), shard_cap,
                                          JaxBM25Config(impact_dtype=impact_dtype, **knobs))
    for name in ("beam", "nonneg", "pcap", "tcap"):
        assert ours[name] == ref[name], name
    for name in ("low_ranges", "post_packed", "term_row", "impact_scale"):
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref[name]), err_msg=name)
    ref_impact = np.asarray(ref["impact"])
    if impact_dtype == "bfloat16":  # compare the bf16 bit patterns
        ours_bits = ours["impact"].view(torch.int16).numpy()
        np.testing.assert_array_equal(ours_bits, ref_impact.view(np.int16))
    else:
        np.testing.assert_array_equal(ours["impact"].numpy(), ref_impact)
    assert int((ours["impact"] != 0).sum()) > 0


# -- searches against JAX -------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", range(len(DENSE_CASES)))
def test_sharded_dense_topk_matches_jax(inputs, port, n_shards, case):
    size, k = DENSE_CASES[case]
    mesh = jax_make_mesh(n_shards)
    fn = jax_sharding.make_sharded_dense_topk(mesh, k=k, block=DENSE_BLOCK)
    jv, ji = fn(jax_sharding.shard_corpus_matrix(jnp.asarray(inputs["dense_emb"]), mesh),
                jnp.asarray(inputs["dense_q"]), jnp.int32(size))
    tv, ti = port[n_shards][f"dense{case}_vals"], port[n_shards][f"dense{case}_idx"]
    assert tv.shape == ti.shape == (5, k)
    assert ((ti >= size) & (ti != -1)).sum() == 0
    live = np.isfinite(np.asarray(jv))
    np.testing.assert_array_equal(np.isfinite(tv), live)
    np.testing.assert_allclose(tv[live], np.asarray(jv)[live], atol=1e-6, rtol=0)
    _assert_agree(np.where(live, tv, 0), ti, np.where(live, jv, 0), ji, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_bm25_topk_matches_jax(inputs, port, n_shards):
    b = inputs["bm25"]
    mesh = jax_make_mesh(n_shards)
    state = {"indptr": b["indptr"], "post_doc": b["post_doc"], "post_w": b["post_w"],
             "docs_per_shard": b["n_docs_cap"] // n_shards}
    st = jax_sharding.shard_bm25_state(state, mesh)
    fn = jax_sharding.make_sharded_bm25_topk(mesh, k=10, max_df=b["max_df"],
                                             n_docs_cap=b["n_docs_cap"])
    jv, ji = (np.asarray(x) for x in fn(st["indptr"], st["post_doc"], st["post_w"],
                                         jnp.asarray(b["qtids"])))
    tv, ti = port[n_shards]["bm25_vals"], port[n_shards]["bm25_idx"]
    live = jv > 0
    np.testing.assert_array_equal(tv > 0, live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=1e-5)
    np.testing.assert_array_equal(ti[live], ji[live])
    np.testing.assert_array_equal(ti[~live], -1)


def _jax_fused(inputs, n_shards, case):
    mode, use_router, use_delta = FUSED_CASES[case]
    f, router = inputs["fused"], inputs["jax_router"]
    mesh = jax_make_mesh(n_shards)
    shard_cap = fused_shard_cap(f["base_docs"], n_shards)
    emb = np.zeros((shard_cap * n_shards, 64), np.float32)
    emb[: f["base_docs"]] = f["emb"][: f["base_docs"]]
    tt = jax_sharding.shard_bm25_twotier(f["csr"], mesh, shard_cap,
                                         JaxBM25Config(impact_dtype=f["impact_dtype"]))
    d = f["delta"]
    fused = jax_sharding.make_fused_sharded_query(
        mesh, shard_cap, router_module=router.module if use_router else None, k=FUSED_K,
        pool=FUSED_POOL, beam=tt["beam"], approx_topk=False, sparse_mode=mode,
        nonneg=tt["nonneg"], delta_cap=d["n_docs_cap"] if use_delta else 0,
        delta_max_df=d["max_df"] if use_delta else 0,
    )
    state = {"emb": jax_sharding.shard_corpus_matrix(
        jnp.asarray(emb).astype(jnp.bfloat16), mesh), "size": jnp.int32(f["base_docs"])}
    state.update({name: tt[name] for name in (
        "low_ranges", "post_packed", "term_row", "impact", "impact_scale")})
    qtids = f["qtids"]
    qterms = {"qtids": jnp.asarray(np.where(qtids < tt["term_row"].shape[0], qtids, -1))}
    if use_delta:
        qterms["qtids_full"] = jnp.asarray(np.where(qtids < d["indptr"].shape[0] - 1, qtids, -1))
        state.update(
            delta_emb=jnp.asarray(d["emb"]).astype(jnp.bfloat16),
            delta_indptr=jnp.asarray(d["indptr"]), delta_post_doc=jnp.asarray(d["post_doc"]),
            delta_post_w=jnp.asarray(d["post_w"]),
            delta_size=jnp.int32(f["n_docs"] - f["base_docs"]),
            delta_base_docs=jnp.int32(f["base_docs"]),
        )
    q = jnp.asarray(f["q"]).astype(jnp.bfloat16)
    if use_router:
        out = fused(state, q, qterms, {"params": router.params, "stats": router.stats})
    else:
        out = fused(state, q, qterms)
    return (np.asarray(x) for x in out)


@pytest.mark.parametrize("n_shards,case", [(s, c) for s in SHARDS for c in JAX_FUSED[s]])
def test_fused_sharded_query_matches_jax(inputs, port, n_shards, case):
    mode, use_router, use_delta = FUSED_CASES[case]
    jv, jp = _jax_fused(inputs, n_shards, case)
    key = f"fused_{mode}_{int(use_router)}{int(use_delta)}"
    tv, tp = port[n_shards][key + "_vals"], port[n_shards][key + "_idx"]
    assert tv.shape == tp.shape == (len(inputs["fused"]["q"]), FUSED_K)
    assert tp.dtype == np.int32 and (tp < inputs["fused"]["n_docs"]).all()
    _assert_agree(tv, tp, jv, jp)
    if use_delta:  # the delta doc with the unique term is found
        assert (tp[4] == 290).any()


@pytest.mark.parametrize("case", range(len(FUSED_CASES)))
def test_fused_results_do_not_depend_on_the_shard_count(port, case):
    mode, use_router, use_delta = FUSED_CASES[case]
    key = f"fused_{mode}_{int(use_router)}{int(use_delta)}"
    for n_shards in SHARDS[1:]:
        _assert_agree(port[n_shards][key + "_vals"], port[n_shards][key + "_idx"],
                      port[2][key + "_vals"], port[2][key + "_idx"], rtol=1e-5, atol=1e-6,
                      raw_min=1.0)


def test_merge_keeps_each_variant_dead_slot_rule():
    vals = torch.tensor([[[3.0, float("-inf")]], [[0.0, -1.0]]])
    idx = torch.tensor([[[4, -1]], [[130, 131]]], dtype=torch.int32)
    v, i = merge_shard_pools(vals, idx, 6)  # dense: -inf dead, padded to k with -inf
    assert v.tolist() == [[3.0, 0.0, -1.0, float("-inf"), float("-inf"), float("-inf")]]
    assert i.tolist() == [[4, 130, 131, -1, -1, -1]]
    v, i = merge_shard_pools(vals, idx, 3, dead_to=0.0)  # fused: dead -> 0.0
    assert v.tolist() == [[3.0, 0.0, -1.0]] and i.tolist() == [[4, 130, 131]]
    v, i = merge_shard_pools(vals, idx, 5, dead_to=0.0, positive_only=True)  # BM25
    assert v.tolist() == [[3.0, 0.0, 0.0, 0.0, 0.0]] and i.tolist() == [[4, -1, -1, -1, -1]]
    ties = torch.tensor([[[1.0, 1.0]], [[1.0, 0.5]]])
    tie_idx = torch.tensor([[[7, 9]], [[130, 131]]], dtype=torch.int32)
    assert merge_shard_pools(ties, tie_idx, 3)[1].tolist() == [[7, 9, 130]]


# -- spawned ranks ----------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", (2, SPAWNED))
@pytest.mark.parametrize("kind", ["dense", "bm25", "fused_twotier", "fused_scatter"])
def test_spawned_ranks_equal_the_in_process_shards(port, spawned, n_shards, kind):
    keys = [k for k in port[n_shards] if k.startswith(kind)]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(spawned[n_shards][key], port[n_shards][key], err_msg=key)
