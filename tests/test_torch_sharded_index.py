"""The port's ``ShardedHybridIndex`` on four gloo ranks, against the JAX
package's on four of the eight virtual devices, mirroring
``tests/test_sharded_index.py``'s cases.

One launch for the module (``tests/test_torch_spawn.py::index_program``)
runs every case in four spawned CPU ranks, with the JAX embedder's hash
table carried across (``convert.embedding_table``); every rank writes its
answers, and the tests read them here beside the JAX index's and the port's
single-device ``HybridRetriever``'s.

Tolerances: the port's answers against the JAX index's and the
single-device retriever's under the tie rule, rank-wise scores within rtol
1e-4 / atol 1e-5, at least 99% of positions equal (the single-device port
tests' rule); within the port, as the JAX tests hold the JAX index: fused
against unfused and scatter against twotier with equal positions and scores
within rtol 1e-5 / atol 1e-6, a reload bit for bit, the approximate path
overlapping the exact one by 0.9, the delta within rtol 0.2 / atol 0.05 of
a fresh full reshard with overlap 0.8. Every rank answers alike, bit for
bit. A directory the JAX index saved loads into the port and answers as
JAX does, and the reverse.
"""

import os
import tempfile

import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

import jax  # noqa: E402

from rag_uq_tpu.core.config import BM25Config as JaxBM25Config  # noqa: E402
from rag_uq_tpu.core.config import DenseIndexConfig as JaxDenseConfig  # noqa: E402
from rag_uq_tpu.core.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rag_uq_tpu.core.types import Document as JaxDocument  # noqa: E402
from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxNgram  # noqa: E402
from rag_uq_tpu.parallel.sharded_index import ShardedHybridIndex as JaxSharded  # noqa: E402
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.convert import embedding_table, load_router  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig, RouterConfig  # noqa: E402
from rag_uq_tpu_torch.core.mesh import _spawn_ranks  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402
from rag_uq_tpu_torch.router.model import RetrievalRouter  # noqa: E402

from tests.oracles import make_synthetic_corpus  # noqa: E402
from tests.test_torch_spawn import INDEX_DIM, INDEX_QUERIES, index_program  # noqa: E402

WORLD = 4
Q = INDEX_QUERIES


def _jax_index(mesh, embedder, docs=None, **bm25):
    idx = JaxSharded(mesh, embedder=embedder,
                     bm25_config=JaxBM25Config(**bm25) if bm25 else None,
                     dense_config=JaxDenseConfig(embedding_dim=INDEX_DIM))
    if docs is not None:
        idx.add_documents([JaxDocument(str(i), t) for i, t in enumerate(docs)])
    return idx


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("index_ranks")
    corpus = make_synthetic_corpus(np.random.default_rng(21), 300)
    embedder = JaxNgram(dim=INDEX_DIM, buckets=4096)
    router = JaxRouter(seed=2)
    mesh = jax_make_mesh(WORLD)
    jidx = _jax_index(mesh, embedder, corpus, impact_dtype="float32")
    jidx.save(str(out / "jax_ckpt"))
    ref = {
        "exact": jidx.search_batch(Q, top_k=10, pool=20, exact=True),
        "router": jidx.search_batch(Q, top_k=5, pool=20, router=router, exact=True),
    }
    inp = {
        "corpus": corpus,
        "table": np.asarray(embedder.table, dtype=np.float32),
        "router_params": jax.tree.map(np.asarray, router.params),
        "router_stats": jax.tree.map(np.asarray, router.stats),
        "jax_ckpt": str(out / "jax_ckpt"),
    }
    _spawn_ranks(index_program, WORLD, (inp, str(out)))
    ranks = [dict(np.load(out / f"index_{r}.npz")) for r in range(WORLD)]
    from_port = _jax_index(mesh, embedder)
    from_port.load(str(out / "port_ckpt"))
    ref["from_port"] = from_port.search_batch(Q, top_k=10, pool=20, exact=True)
    ref["from_port_len"] = len(from_port)
    return {"port": ranks[0], "ranks": ranks, "jax": ref, "inp": inp, "corpus": corpus}


def _agree(tv, tp, jv, jp):
    agree = tie_aware_agreement(np.asarray(tv), np.asarray(tp), np.asarray(jv), np.asarray(jp),
                                rtol=1e-4, atol=1e-5)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:3]
    assert agree["raw_idx_agreement"] >= 0.99, agree


def _single_device(run, router=None, top_k=10):
    inp = run["inp"]
    ours = HybridRetriever(
        embedder=NgramHashEmbedder(dim=INDEX_DIM, buckets=4096,
                                   table=embedding_table(inp["table"]), device="cpu"),
        bm25_config=BM25Config(impact_dtype="float32"),
        dense_config=DenseIndexConfig(embedding_dim=INDEX_DIM), device="cpu")
    ours.add_documents([Document(str(i), t) for i, t in enumerate(run["corpus"])])
    return ours.hybrid_search_batch(Q, top_k=top_k, retrieval_pool_size=20, router=router,
                                    approx=False)


def test_every_rank_answers_alike(run):
    port = run["port"]
    assert int(port["n_shards"]) == WORLD and int(port["shard_cap"]) == 128
    for other in run["ranks"][1:]:
        assert set(other) == set(port)
        for key, value in port.items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_matches_jax_and_the_single_device_retriever(run):
    p = run["port"]
    assert p["exact_vals"].shape == p["exact_idx"].shape == (len(Q), 10)
    _agree(p["exact_vals"], p["exact_idx"], *run["jax"]["exact"])
    _agree(p["exact_vals"], p["exact_idx"], *_single_device(run))


def test_fused_matches_unfused_oracle(run):
    p = run["port"]
    np.testing.assert_array_equal(p["exact_idx"], p["unfused_idx"])
    np.testing.assert_allclose(p["exact_vals"], p["unfused_vals"], rtol=1e-5, atol=1e-6)


def test_fused_scatter_mode_matches_twotier(run):
    p = run["port"]
    np.testing.assert_array_equal(p["scatter_idx"], p["exact_idx"])
    np.testing.assert_allclose(p["scatter_vals"], p["exact_vals"], rtol=1e-5, atol=1e-6)


def test_fused_approx_overlaps_exact(run):
    p = run["port"]
    overlap = np.mean([
        len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
        for a, b in zip(p["approx_idx"], p["exact_idx"])
    ])
    assert overlap >= 0.9


def test_router_fusion_matches_jax_and_the_single_device_retriever(run):
    p = run["port"]
    _agree(p["router_vals"], p["router_idx"], *run["jax"]["router"])
    router = load_router(RetrievalRouter(RouterConfig(), device="cpu"),
                         run["inp"]["router_params"], run["inp"]["router_stats"])
    _agree(p["router_vals"], p["router_idx"], *_single_device(run, router, top_k=5))


def test_router_fused_matches_unfused(run):
    p = run["port"]
    np.testing.assert_array_equal(p["router_idx"], p["unfused_router_idx"])
    np.testing.assert_allclose(p["router_vals"], p["unfused_router_vals"], rtol=1e-5, atol=1e-6)


def test_save_load_roundtrip(run):
    p = run["port"]
    assert int(p["restored_len"]) == 300
    np.testing.assert_array_equal(p["restored_idx"], p["saved_idx"])
    np.testing.assert_array_equal(p["restored_vals"], p["saved_vals"])


def test_save_load_roundtrip_unfused(run):
    p = run["port"]
    np.testing.assert_array_equal(p["restored_unfused_idx"], p["saved_idx"])
    np.testing.assert_allclose(p["restored_unfused_vals"], p["saved_vals"], rtol=1e-5, atol=1e-6)


def test_loads_a_directory_the_jax_index_saved(run):
    p = run["port"]
    assert int(p["from_jax_len"]) == 300
    _agree(p["from_jax_vals"], p["from_jax_idx"], *run["jax"]["exact"])


def test_the_jax_index_loads_a_directory_the_port_saved(run):
    assert run["jax"]["from_port_len"] == 300
    _agree(*run["jax"]["from_port"], run["port"]["exact_vals"], run["port"]["exact_idx"])


def test_incremental_add_resyncs(run):
    p = run["port"]
    assert int(p["inc_len"]) == 100
    assert p["inc_idx"].shape == (1, 5) and (p["inc_idx"][p["inc_idx"] >= 0] < 100).all()


def test_delta_sync_avoids_reshard_and_serves_new_docs(run):
    p = run["port"]
    assert p["delta_unique_idx"][0][0] == 280  # the sparse path finds the delta doc
    assert 280 in p["delta_hybrid_idx"][0]  # and the hybrid path, its dense delta too
    assert bool(p["delta_kept_base"])


def test_overflow_triggers_full_reshard(run):
    p = run["port"]
    assert bool(p["overflow_resharded"])
    assert p["overflow_unique_idx"][0][0] == 280


def test_delta_staleness_bounded(run):
    p = run["port"]
    assert bool(p["stale_resharded"])
    dp, fp = p["stale_delta_idx"], p["stale_fresh_idx"]
    overlap = np.mean([
        len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1) for a, b in zip(dp, fp)
    ])
    assert overlap >= 0.8
    live = (dp >= 0) & (fp >= 0)
    np.testing.assert_allclose(p["stale_delta_vals"][live], p["stale_fresh_vals"][live],
                               rtol=0.2, atol=0.05)


def test_pool_exceeds_shard_capacity(run):
    p = run["port"]  # shard_cap = 128 for 300 docs over 4 shards; pool 200 > 128
    assert p["pool200_vals"].shape == (2, 10)
    assert (p["pool200_idx"][p["pool200_idx"] >= 0] < 300).all()


def test_load_detaches_checkpoint_and_keeps_config(run):
    p = run["port"]
    assert int(p["cfg_threshold"]) == 16
    assert bool(p["cfg_detached"]) and bool(p["cfg_untouched"])


# The JAX bench's result keys (rag_uq_tpu/cli/bench_sharded.py:175-287);
# the port names its throughput "qps" (cpu_mesh_qps was the CPU mesh's).
JAX_BENCH_KEYS = {
    "n_docs", "n_devices", "backend", "batch", "pool", "k", "corpus_gen_s", "doc_wrap_s",
    "ingest_s", "shard_layout_s", "shard_cap", "twotier", "fused_exact_first_batch_s",
    "unfused_first_batch_s", "score_resolution_rtol", "impact_dtype",
    "fused_vs_unfused_idx_agreement", "fused_vs_unfused_tie_aware_agreement",
    "rankwise_max_abs_score_diff", "approx_compile_plus_first_s",
    "approx_steady_s_per_batch", "note",
}


def test_bench_sharded_cli_on_one_cpu_rank(tmp_path):
    import json

    import torch.distributed as dist

    from rag_uq_tpu.cli import bench_sharded as jax_bench
    from rag_uq_tpu_torch.cli import bench_sharded

    assert bench_sharded.synthetic_corpus_texts(50, seed=3) == jax_bench.synthetic_corpus_texts(
        50, seed=3)
    bench_sharded.main(["--docs", "3000", "--batch", "32", "--device", "cpu",
                        "--outdir", str(tmp_path)])
    assert not dist.is_initialized()  # main leaves no group behind
    got = json.loads((tmp_path / "results.json").read_text())
    assert JAX_BENCH_KEYS <= set(got) and "cpu_mesh_qps" not in got
    assert got["n_docs"] == 3000 and got["n_devices"] == 1 and got["collective"] == "gloo"
    assert got["fused_vs_unfused_tie_aware_agreement"] == 1.0 and got["qps"] > 0
    assert "exactness_violations" not in got


def test_query_batch_result_is_the_jax_dataclass():
    import dataclasses

    from rag_uq_tpu.core.types import QueryBatchResult as JaxResult
    from rag_uq_tpu_torch.core.types import QueryBatchResult

    assert ([(f.name, str(f.type)) for f in dataclasses.fields(QueryBatchResult)]
            == [(f.name, str(f.type)) for f in dataclasses.fields(JaxResult)])
    scores, indices = [[0.9, 0.5, 0.0]], [[3, 7, -1]]
    ours, ref = QueryBatchResult(scores, indices), JaxResult(scores, indices)
    assert isinstance(ours.scores, np.ndarray) and isinstance(ours.indices, np.ndarray)
    assert (ours.batch_size, ours.k) == (ref.batch_size, ref.k) == (1, 3)
    np.testing.assert_array_equal(ours.indices, ref.indices)
