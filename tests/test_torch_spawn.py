"""The port's rank launcher (``core/mesh.py::_spawn_ranks``), and the
programs the multi-rank tests run in their ranks.

The launched ranks import the program they run by its module path, so the
programs live here, in a module that imports nothing of JAX: each child
then starts with torch and the port alone. A test module spawns its ranks
once (a module-scoped fixture), the ranks write numpy files, and the
parametrised tests read them. This module's own tests hold the launcher: a
failing rank fails the launch, a hung one is killed at the time limit, and
the ranks meet in one group even when launches run side by side.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import pytest
import torch
import torch.distributed as dist

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu_torch.convert import embedding_table, load_router  # noqa: E402
from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig, RouterConfig  # noqa: E402
from rag_uq_tpu_torch.core.mesh import _spawn_ranks, gather_shards, make_mesh, mesh_rank  # noqa: E402
from rag_uq_tpu_torch.core.types import Document  # noqa: E402
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.embed.train import ContrastiveTrainer, EncoderTrainConfig  # noqa: E402
from rag_uq_tpu_torch.parallel.sharded_index import ShardedHybridIndex  # noqa: E402
from rag_uq_tpu_torch.parallel.sharding import (  # noqa: E402
    bm25_state_layout,
    bm25_twotier_layout,
    local_twotier,
    make_fused_sharded_query,
    make_sharded_bm25_topk,
    make_sharded_dense_topk,
    run_in_process,
    shard_bm25_state,
    shard_bm25_twotier,
    shard_corpus_matrix,
    shard_rows,
)
from rag_uq_tpu_torch.router.model import RetrievalRouter  # noqa: E402

# -- the launcher's own tests ---------------------------------------------------------


def _ranks_meet(rank: int, world: int, outdir: str) -> None:
    mesh = make_mesh(device="cpu")
    got = gather_shards(torch.tensor([rank * 10 + world]), mesh)
    np.save(Path(outdir) / f"meet_{rank}.npy", got.numpy())


def _fails_on_rank_one(rank: int, world: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def _hangs(rank: int, world: int) -> None:
    time.sleep(600)


def test_two_launches_side_by_side_each_meet_in_their_own_group(tmp_path):
    outs = [tmp_path / "a", tmp_path / "b"]
    for out in outs:
        out.mkdir()
    threads = [threading.Thread(target=_spawn_ranks, args=(_ranks_meet, 2, (str(out),)))
               for out in outs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for out in outs:
        for rank in range(2):
            assert np.load(out / f"meet_{rank}.npy").tolist() == [[2], [12]]


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        _spawn_ranks(_fails_on_rank_one, 2, timeout_s=300)


def test_a_hung_rank_is_killed_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        _spawn_ranks(_hangs, 2, timeout_s=5)
    assert time.monotonic() - t0 < 60


# -- test_torch_mesh.py ----------------------------------------------------------------

MESH_TEXTS_HASH = [f"doc number {i} about topic {i % 5}" for i in range(11)]
MESH_TEXTS_ENC = [f"short text {i}" for i in range(9)]
MESH_ENCODER = dict(dim=32, num_layers=1, num_heads=2, mlp_dim=64, max_seq_len=16,
                    vocab_buckets=512)


def mesh_program(rank: int, world: int, outdir: str) -> None:
    """make_mesh on a group, its error, a sub-mesh, and encode_mesh of both
    embedders on an uneven batch, each against encode on this rank."""
    mesh = make_mesh(device="cpu")
    out: Dict[str, Any] = {"size": mesh.size(), "rank": mesh_rank(mesh)}
    try:
        make_mesh(world + 1, device="cpu")
        out["too_many"] = ""
    except ValueError as e:
        out["too_many"] = str(e)
    sub = make_mesh(2, device="cpu")
    coord = sub.get_coordinate()
    out["sub_coord"] = -1 if coord is None else coord[0]
    hash_emb = NgramHashEmbedder(dim=64, buckets=1024, device="cpu")
    out["hash_mesh"] = hash_emb.encode_mesh(MESH_TEXTS_HASH, mesh)
    out["hash_one"] = hash_emb.encode(MESH_TEXTS_HASH)
    out["hash_sub"] = (hash_emb.encode_mesh(MESH_TEXTS_HASH, sub) if coord is not None
                       else out["hash_one"])
    enc = TransformerEmbedder(EncoderConfig(**MESH_ENCODER), device="cpu")
    out["enc_mesh"] = enc.encode_mesh(MESH_TEXTS_ENC, mesh)
    out["enc_one"] = enc.encode(MESH_TEXTS_ENC)
    out["empty"] = hash_emb.encode_mesh([], mesh)
    np.savez(Path(outdir) / f"mesh_{rank}.npz", **out)


# -- test_torch_sharding.py ------------------------------------------------------------

DENSE_CASES = ((900, 10), (200, 5), (1000, 200))  # (live rows, k) over 1024 rows
DENSE_BLOCK = 256
FUSED_CASES = (  # (sparse mode, router, delta)
    ("twotier", False, False),
    ("twotier", True, True),
    ("scatter", False, True),
    ("scatter", True, False),
)
FUSED_POOL, FUSED_K = 20, 10


def fused_shard_cap(n_docs: int, n_shards: int) -> int:
    """ShardedHybridIndex._sync_full's shard capacity."""
    per = max(-(-n_docs // n_shards), 1)
    return max(128, 1 << (per - 1).bit_length())


def _router(inp: Dict[str, Any]) -> RetrievalRouter:
    router = RetrievalRouter(RouterConfig(), device="cpu")
    return load_router(router, inp["router_params"], inp["router_stats"])


def _fused_state(inp, twotier, emb_rows, with_delta: bool):
    state = {"emb": emb_rows, **{name: twotier[name] for name in (
        "low_ranges", "post_packed", "term_row", "impact", "impact_scale")}}
    state["size"] = inp["base_docs"]
    qterms = {"qtids": torch.from_numpy(
        np.where(inp["qtids"] < twotier["term_row"].shape[0], inp["qtids"], -1))}
    if with_delta:
        d = inp["delta"]
        qterms["qtids_full"] = torch.from_numpy(
            np.where(inp["qtids"] < d["indptr"].shape[0] - 1, inp["qtids"], -1))
        state.update(
            delta_emb=torch.tensor(d["emb"]).to(emb_rows.dtype),
            delta_indptr=torch.tensor(d["indptr"]),
            delta_post_doc=torch.tensor(d["post_doc"]),
            delta_post_w=torch.tensor(d["post_w"]),
            delta_size=inp["n_docs"] - inp["base_docs"],
            delta_base_docs=inp["base_docs"],
        )
    return state, qterms


def sharding_results(inp: Dict[str, Any], n_shards: int, mesh=None) -> Dict[str, np.ndarray]:
    """Every sharded search of ``inp`` at ``n_shards`` shards: on ``mesh``
    through the ``make_*`` callables (this rank's shard, the all-gather),
    or without one in this process through ``run_in_process``."""
    out: Dict[str, np.ndarray] = {}
    shards = range(n_shards)

    emb, q = torch.from_numpy(inp["dense_emb"]), torch.from_numpy(inp["dense_q"])
    for j, (size, k) in enumerate(DENSE_CASES):
        fn = make_sharded_dense_topk(mesh, k=k, block=DENSE_BLOCK)
        if mesh is None:
            v, i = run_in_process(fn, [(shard_rows(emb, n_shards, s), q, size) for s in shards])
        else:
            v, i = fn(shard_corpus_matrix(emb, mesh), q, size)
        out[f"dense{j}_vals"], out[f"dense{j}_idx"] = v.numpy(), i.numpy()

    b = inp["bm25"]
    state = {"indptr": b["indptr"], "post_doc": b["post_doc"], "post_w": b["post_w"],
             "docs_per_shard": b["n_docs_cap"] // n_shards}
    qtids = torch.from_numpy(b["qtids"])
    fn = make_sharded_bm25_topk(mesh, k=10, max_df=b["max_df"], n_docs_cap=b["n_docs_cap"],
                                n_shards=n_shards)
    if mesh is None:
        lay = bm25_state_layout(state, n_shards)
        v, i = run_in_process(fn, [
            tuple(torch.from_numpy(lay[name][s]) for name in ("indptr", "post_doc", "post_w"))
            + (qtids,) for s in shards])
    else:
        local = shard_bm25_state(state, mesh)
        v, i = fn(local["indptr"], local["post_doc"], local["post_w"], qtids)
    out["bm25_vals"], out["bm25_idx"] = v.numpy(), i.numpy()

    f = inp["fused"]
    shard_cap = fused_shard_cap(f["base_docs"], n_shards)
    cfg = BM25Config(impact_dtype=f["impact_dtype"])
    emb = np.zeros((shard_cap * n_shards, f["emb"].shape[1]), np.float32)
    emb[: f["base_docs"]] = f["emb"][: f["base_docs"]]
    emb = torch.from_numpy(emb).to(getattr(torch, f["emb_dtype"]))
    if mesh is None:
        layout = meta = bm25_twotier_layout(f["csr"], n_shards, shard_cap, cfg)
    else:
        local = meta = shard_bm25_twotier(f["csr"], mesh, shard_cap, cfg)
    router = _router(f)
    for mode, use_router, use_delta in FUSED_CASES:
        fn = make_fused_sharded_query(
            mesh, shard_cap, router_module=router.module if use_router else None,
            k=FUSED_K, pool=FUSED_POOL, beam=meta["beam"], approx_topk=False,
            sparse_mode=mode, nonneg=meta["nonneg"],
            delta_cap=f["delta"]["n_docs_cap"] if use_delta else 0,
            delta_max_df=f["delta"]["max_df"] if use_delta else 0,
        )
        if mesh is None:
            args = [_fused_state(f, local_twotier(layout, s), shard_rows(emb, n_shards, s),
                                 use_delta) for s in shards]
            q_vecs = torch.from_numpy(f["q"])
            v, i = run_in_process(fn, [(st, q_vecs, qt) for st, qt in args],
                                  (args[0][0], q_vecs, args[0][1]))
        else:
            st, qt = _fused_state(f, local, shard_corpus_matrix(emb, mesh), use_delta)
            v, i = fn(st, torch.from_numpy(f["q"]), qt)
        key = f"fused_{mode}_{int(use_router)}{int(use_delta)}"
        out[key + "_vals"], out[key + "_idx"] = v.numpy(), i.numpy()
    return out


def sharding_program(rank: int, world: int, inp: Dict[str, Any], outdir: str) -> None:
    """``sharding_results`` on a mesh over every rank, then on a mesh over
    ranks 0 and 1 (the others wait); rank 0 of each writes the results."""
    full = sharding_results(inp, world, make_mesh(device="cpu"))
    if rank == 0:
        np.savez(Path(outdir) / f"sharding_{world}.npz", **full)
    sub = make_mesh(2, device="cpu")
    if sub.get_coordinate() is not None:
        half = sharding_results(inp, 2, sub)
        if rank == 0:
            np.savez(Path(outdir) / "sharding_2.npz", **half)
    dist.barrier()


# -- test_torch_sharded_index.py -------------------------------------------------------

INDEX_QUERIES = ["w1 w2 the", "w10 w3", "the is a w5", "w7"]
INDEX_DIM = 64


def _index(inp, mesh, n: Optional[int] = None, **bm25) -> ShardedHybridIndex:
    emb = NgramHashEmbedder(dim=INDEX_DIM, buckets=4096, table=embedding_table(inp["table"]),
                            device="cpu")
    idx = ShardedHybridIndex(mesh, embedder=emb, bm25_config=BM25Config(**bm25) if bm25 else None,
                             dense_config=DenseIndexConfig(embedding_dim=INDEX_DIM))
    if n is not None:
        idx.add_documents([Document(str(i), t) for i, t in enumerate(inp["corpus"][:n])])
    return idx


def index_program(rank: int, world: int, inp: Dict[str, Any], outdir: str) -> None:
    """The sharded index's cases on a mesh over every rank. Every rank
    writes its results (the parent checks that they agree); the checkpoint
    directories are written by rank 0."""
    mesh = make_mesh(device="cpu")
    out: Dict[str, Any] = {}
    q = INDEX_QUERIES
    corpus: List[str] = inp["corpus"]
    router = _router(inp)

    idx = _index(inp, mesh, len(corpus), impact_dtype="float32")
    out["n_shards"] = idx.n_shards
    out["shard_cap"] = idx.sync()["shard_cap"]
    for name, kw in (("exact", dict(exact=True)), ("approx", dict(exact=False)),
                     ("scatter", dict(exact=True, sparse_mode="scatter")),
                     ("router", dict(exact=True, router=router, top_k=5))):
        kw = {"top_k": 10, "pool": 20, **kw}
        out[f"{name}_vals"], out[f"{name}_idx"] = idx.search_batch(q, **kw)
    out["unfused_vals"], out["unfused_idx"] = idx.search_batch_unfused(q, top_k=10, pool=20)
    out["unfused_router_vals"], out["unfused_router_idx"] = idx.search_batch_unfused(
        q, top_k=5, pool=20, router=router)
    out["pool200_vals"], out["pool200_idx"] = idx.search_batch(q[:2], top_k=10, pool=200)

    # Save and load on this mesh; the JAX package's directory; the port's
    # directory for the JAX package (written by rank 0).
    idx.save(str(Path(outdir) / "port_ckpt"))
    restored = _index(inp, mesh)
    restored.load(str(Path(outdir) / "port_ckpt"))
    out["restored_len"] = len(restored)
    out["saved_vals"], out["saved_idx"] = idx.search_batch(q[:2], top_k=5, pool=20)
    out["restored_vals"], out["restored_idx"] = restored.search_batch(q[:2], top_k=5, pool=20)
    out["restored_unfused_vals"], out["restored_unfused_idx"] = (
        restored.search_batch_unfused(q[:2], top_k=5, pool=20))
    from_jax = _index(inp, mesh)
    from_jax.load(inp["jax_ckpt"])
    out["from_jax_len"] = len(from_jax)
    out["from_jax_vals"], out["from_jax_idx"] = from_jax.search_batch(
        q, top_k=10, pool=20, exact=True)

    # Incremental add: a full resync.
    inc = _index(inp, mesh, 50)
    inc.search_batch(["w1 w2"], top_k=5)
    inc.add_documents([Document(str(i), corpus[i]) for i in range(50, 100)])
    out["inc_len"] = len(inc)
    out["inc_vals"], out["inc_idx"] = inc.search_batch(["w1 w2"], top_k=5)

    # Live ingest under delta_sync_fraction 0.25 over 280 docs.
    live = _index(inp, mesh, 280, impact_dtype="float32", delta_sync_fraction=0.25)
    live.search_batch(["w1"], top_k=5, pool=20)
    base_emb = live.sync()["emb"]
    live.add_documents([Document("new1", "zzuniquetoken zzuniquetoken w1"),
                        Document("new2", corpus[281])])
    out["delta_unique_idx"] = live.search_batch(["zzuniquetoken"], top_k=5, pool=20)[1]
    out["delta_hybrid_idx"] = live.search_batch(["zzuniquetoken zzuniquetoken w1"], top_k=3,
                                                pool=20)[1]
    state = live.sync()
    out["delta_kept_base"] = ("delta" in state and live._base["docs"] == 280
                              and state["emb"] is base_emb)
    live.add_documents([Document(f"bulk{i}", corpus[i % 300] + f" extra{i}")
                        for i in range(100)])
    state = live.sync()
    out["overflow_resharded"] = "delta" not in state and live._base["docs"] == len(live)
    out["overflow_unique_idx"] = live.search_batch(["zzuniquetoken"], top_k=5, pool=20)[1]

    stale = _index(inp, mesh, 280, impact_dtype="float32", delta_sync_fraction=0.25)
    stale.search_batch(["w1"], top_k=5, pool=20)
    stale.add_documents([Document(f"d{i}", corpus[280 + i]) for i in range(16)])
    sq = ["w1 w2", "w10 w3", "the is a w5"]
    out["stale_delta_vals"], out["stale_delta_idx"] = stale.search_batch(sq, top_k=10, pool=20,
                                                                         exact=True)
    out["stale_fresh_vals"], out["stale_fresh_idx"] = stale.search_batch_unfused(
        sq, top_k=10, pool=20)
    out["stale_resharded"] = "delta" not in stale.sync()

    # A loaded index keeps the saved BM25 config and is detached from the files.
    cfg_idx = _index(inp, mesh, 50, dense_tier_threshold=16)
    cfg_idx.save(str(Path(outdir) / "cfg_ckpt"))
    loaded = _index(inp, mesh)
    loaded.load(str(Path(outdir) / "cfg_ckpt"))
    before = (Path(outdir) / "cfg_ckpt" / "bm25.json").stat().st_mtime_ns
    out["cfg_threshold"] = loaded.bm25.config.dense_tier_threshold
    out["cfg_detached"] = loaded.bm25.persist_path is None
    loaded.add_documents([Document("newdoc", corpus[51])])
    out["cfg_untouched"] = (Path(outdir) / "cfg_ckpt" / "bm25.json").stat().st_mtime_ns == before
    dist.barrier()
    np.savez(Path(outdir) / f"index_{rank}.npz", **out)


# -- test_torch_train_encoder.py ---------------------------------------------------------

DP_ENCODER = dict(dim=32, num_layers=1, num_heads=2, mlp_dim=64, max_seq_len=32,
                  vocab_buckets=2048, dtype="float32")
DP_TRAIN = dict(learning_rate=3e-3, warmup_steps=0, total_steps=10, batch_size=16, seed=0)


def dp_trainer() -> ContrastiveTrainer:
    """A seeded trainer: the same initial weights in every process."""
    return ContrastiveTrainer(config=EncoderTrainConfig(**DP_TRAIN),
                              encoder_config=EncoderConfig(**DP_ENCODER), device="cpu")


def train_program(rank: int, world: int, batches: List, outdir: str) -> None:
    """The data-parallel step on a mesh over every rank: the first batch's
    loss and summed gradients, then two steps' losses and the parameters."""
    mesh = make_mesh(device="cpu")
    trainer = dp_trainer()
    out: Dict[str, Any] = {}
    out["loss0"] = trainer.backward_on_mesh(*batches[0], mesh)
    for j, p in enumerate(trainer.optimizer.params):
        out[f"grad_{j}"] = p.grad.numpy().copy()
        p.grad = None
    step = trainer.make_train_step(mesh)
    out["losses"] = np.asarray([step(*b) for b in batches])
    for j, p in enumerate(trainer.optimizer.params):
        out[f"param_{j}"] = p.detach().numpy().copy()
    np.savez(Path(outdir) / f"train_{rank}.npz", **out)
