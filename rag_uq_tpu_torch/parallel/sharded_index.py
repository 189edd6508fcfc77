"""Corpus-sharded hybrid index: the counterpart of
``rag_uq_tpu/parallel/sharded_index.py``, the multi-device deployment of the
retriever.

SPMD: every rank of the mesh builds this index from the same documents in the
same order, so each holds the same host state (documents, BM25 host CSR, host
embeddings); ``add_documents`` embeds data-parallel (``encode_mesh``), each
rank hashing and encoding its slice of a batch. ``sync()`` lays out only the
calling rank's shard on its device: its row range of the dense matrix and
its two-tier BM25 layout with global statistics. Queries are replicated;
each rank takes exact top-pools of its shard, the (score, global id) pools
are all-gathered, and the replicated tail (delta, union merge, fixed fusion
or learned router, final top-k) is the single-device fused query's, so every
rank returns the single-device answer.

Small live adds after a full layout are laid out as a replicated delta with
the base's frozen idf and avgdl (``delta_sync_fraction``), as in the JAX
package; ``save``/``load`` read and write the JAX package's directory format
(``embeddings.npy``, ``bm25.json`` with its ``.npz``, ``manifest.json``), so
a directory saved by either package loads into the other. Rank 0 writes and
every rank waits at a barrier after.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.core.mesh import mesh_device, mesh_rank
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.embed.base import Embedder, get_embedder
from rag_uq_tpu_torch.index.sparse import BM25Index, build_delta_csr
from rag_uq_tpu_torch.index.twotier import next_pow2
from rag_uq_tpu_torch.parallel.sharding import (
    make_fused_sharded_query,
    make_sharded_bm25_topk,
    make_sharded_dense_topk,
    shard_bm25_state,
    shard_bm25_twotier,
    shard_corpus_matrix,
)
from rag_uq_tpu_torch.retrieval.fused import fuse_pools_select

logger = logging.getLogger(__name__)


class ShardedHybridIndex:
    """Hybrid retrieval over a corpus sharded across the mesh's ranks."""

    def __init__(
        self,
        mesh: DeviceMesh,
        embedder: Optional[Embedder] = None,
        bm25_config: Optional[BM25Config] = None,
        dense_config: Optional[DenseIndexConfig] = None,
        embedder_config: Optional[EmbedderConfig] = None,
    ):
        self.mesh = mesh
        self.n_shards = mesh.size()
        self.device = mesh_device(mesh)
        self.dense_config = dense_config or DenseIndexConfig()
        self.embedder = embedder or get_embedder(
            embedder_config or EmbedderConfig(dim=self.dense_config.embedding_dim),
            device=self.device,
        )
        # The BM25Index host buffers double as the doc store; dense
        # embeddings accumulate on the host and are laid out at sync.
        self._bm25_config = bm25_config
        self.bm25 = BM25Index(config=bm25_config, device=self.device)
        self._host_emb: list = []
        self._synced: Optional[Dict[str, Any]] = None
        self._dirty = False
        # Frozen-statistics snapshot of the last full layout, for the
        # replicated live-ingest delta (bm25.config.delta_sync_fraction).
        self._base: Optional[Dict[str, Any]] = None

    def __len__(self) -> int:
        return len(self.bm25.store)

    @property
    def documents(self):
        return self.bm25.store

    def add_documents(self, documents: Sequence[Document], batch_size: int = 256):
        seen = {}
        for d in documents:
            if d.id not in self.bm25.store and d.id not in seen:
                seen[d.id] = d
        fresh = list(seen.values())
        if hasattr(self.embedder, "encode_mesh"):
            def encode(texts):
                return self.embedder.encode_mesh(texts, self.mesh)
        else:
            encode = self.embedder.encode
        for i in range(0, len(fresh), batch_size):
            vecs = np.asarray(encode([d.text for d in fresh[i : i + batch_size]]))
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            self._host_emb.append(vecs / np.maximum(norms, 1e-12))
        self.bm25.add_documents(fresh)
        self._dirty = True
        return {"added": len(fresh), "total_documents": len(self)}

    # -- device layout ----------------------------------------------------------------

    def _delta_fraction(self) -> float:
        if self._base is None or self._base["docs"] == 0:
            return float("inf")
        return (len(self) - self._base["docs"]) / self._base["docs"]

    def sync(self) -> Dict[str, Any]:
        """(Re)build this rank's device layout; lazy and delta-aware.

        With ``bm25.config.delta_sync_fraction > 0`` and few enough docs
        added since the last full layout, only a replicated delta is built
        (dense rows and a delta CSR with the base's frozen idf and avgdl,
        ``index/sparse.py::build_delta_csr``), merged into every query; the
        sharded base stays as it is. A full reshard runs once the fraction
        is exceeded.
        """
        if self._synced is not None and not self._dirty:
            return self._synced
        frac = self.bm25.config.delta_sync_fraction
        if self._synced is not None and frac > 0.0 and self._delta_fraction() <= frac:
            return self._sync_delta()
        return self._sync_full()

    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.dense_config.dtype)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync_delta(self) -> Dict[str, Any]:
        base = self._base
        n = len(self)
        n_delta = n - base["docs"]
        lo, hi = base["postings"], self.bm25._n_postings
        delta_csr = build_delta_csr(
            self.bm25._tid[lo:hi], self.bm25._doc[lo:hi], self.bm25._tf[lo:hi],
            self.bm25.doc_lens, len(self.bm25.vocab), base, self.bm25.k1, self.bm25.b,
            n_delta,
        )
        dcap = delta_csr["n_docs_cap"]
        demb = np.zeros((dcap, self.dense_config.embedding_dim), np.float32)
        demb[:n_delta] = self._host_emb_tail(n_delta)
        self._synced["delta"] = {
            "emb": self._to_device(demb).to(self._dtype()),
            "indptr": self._to_device(delta_csr["indptr"]),
            "post_doc": self._to_device(delta_csr["post_doc"]),
            "post_w": self._to_device(delta_csr["post_w"]),
            "n_docs_cap": dcap,
            "max_df": delta_csr["max_df"],
            "base_docs": base["docs"],
        }
        self._dirty = False
        logger.info("Sharded delta sync: +%d docs replicated over a %d-doc base",
                    n_delta, base["docs"])
        return self._synced

    def _host_emb_tail(self, n_delta: int) -> np.ndarray:
        """The last ``n_delta`` embedding rows, walking the chunk list from
        the tail: O(delta) host work a delta sync."""
        if n_delta <= 0:
            return np.zeros((0, self.dense_config.embedding_dim), np.float32)
        tail: list = []
        need = n_delta
        for chunk in reversed(self._host_emb):
            take = min(need, chunk.shape[0])
            tail.append(chunk[chunk.shape[0] - take :])
            need -= take
            if need == 0:
                break
        return np.concatenate(tail[::-1], axis=0)

    def _sync_full(self) -> Dict[str, Any]:
        n = len(self)
        shard_cap = next_pow2(max(-(-n // self.n_shards), 1), floor=128)
        cap = shard_cap * self.n_shards

        emb = np.zeros((cap, self.dense_config.embedding_dim), dtype=np.float32)
        if self._host_emb:
            stacked = np.concatenate(self._host_emb, axis=0)
            emb[: stacked.shape[0]] = stacked
            # Consolidated, so later delta syncs and saves never concatenate
            # the whole chunk list again.
            self._host_emb = [stacked]
        emb_local = shard_corpus_matrix(torch.from_numpy(emb), self.mesh).to(self._dtype())

        csr = self.bm25.host_csr()
        bm25_local = shard_bm25_state(
            {
                "indptr": csr["indptr"].astype(np.int32),
                "post_doc": csr["doc"].astype(np.int32),
                "post_w": csr["w"].astype(np.float32),
                "docs_per_shard": shard_cap,
            },
            self.mesh,
        )
        twotier = shard_bm25_twotier(csr, self.mesh, shard_cap, self.bm25.config)
        self._synced = {
            "emb": emb_local,
            "cap": cap,
            "shard_cap": shard_cap,
            "bm25": bm25_local,
            "twotier": twotier,
            "max_df": csr["max_df"],
        }
        df = np.asarray(csr["df"])
        idf = np.zeros(df.shape[0], dtype=np.float64)
        active = df > 0
        if active.any():
            idf[active] = np.log(n - df[active] + 0.5) - np.log(df[active] + 0.5)
            eps = self.bm25.config.idf_epsilon * idf[active].mean()
            idf[active & (idf < 0)] = eps
        else:
            eps = 0.0
        doc_lens = np.asarray(self.bm25.doc_lens, dtype=np.float64)
        self._base = {
            "docs": n,
            "postings": self.bm25._n_postings,
            "idf": idf,
            "eps": float(eps),
            "avgdl": float(doc_lens.mean()) if n else 1.0,
        }
        self._dirty = False
        logger.info("Sharded index synced: %d docs over %d shards (cap %d/shard)",
                    n, self.n_shards, shard_cap)
        return self._synced

    # -- persistence ------------------------------------------------------------------

    def _barrier(self) -> None:
        if self.n_shards > 1:
            dist.barrier(group=self.mesh.get_group())

    def save(self, directory: str) -> None:
        """Checkpoint the host build state (embeddings, BM25, manifest).

        The device layout is derived state: a load on any number of ranks
        lays it out again at the next sync. Rank 0 writes; every rank waits
        at a barrier until the files are complete.
        """
        if mesh_rank(self.mesh) == 0:
            out = Path(directory)
            out.mkdir(parents=True, exist_ok=True)
            emb = (
                np.concatenate(self._host_emb, axis=0) if self._host_emb
                else np.zeros((0, self.dense_config.embedding_dim), np.float32)
            )
            np.save(out / "embeddings.npy", emb)
            prev_path, prev_auto = self.bm25.persist_path, self.bm25.autosave
            self.bm25.save(str(out / "bm25.json"))
            self.bm25.persist_path, self.bm25.autosave = prev_path, prev_auto
            with open(out / "manifest.json", "w") as f:
                json.dump({
                    "n_docs": len(self),
                    "dim": self.dense_config.embedding_dim,
                    "bm25_config": dataclasses.asdict(self.bm25.config),
                }, f)
            logger.info("Saved sharded index (%d docs) to %s", len(self), out)
        self._barrier()

    def load(self, directory: str) -> None:
        out = Path(directory)
        with open(out / "manifest.json") as f:
            manifest = json.load(f)
        cfg = (BM25Config(**manifest["bm25_config"]) if "bm25_config" in manifest
               else self._bm25_config)
        self.bm25 = BM25Index(persist_path=str(out / "bm25.json"), config=cfg,
                              device=self.device)
        # Detached from the checkpoint: later adds must not rewrite
        # bm25.json while the manifest and embeddings stay as they were.
        self.bm25.persist_path = None
        emb = np.load(out / "embeddings.npy")
        self._host_emb = [emb] if emb.shape[0] else []
        self._synced = None
        if len(self) != manifest["n_docs"] or emb.shape[0] != len(self):
            raise ValueError(f"{out}: {len(self)} documents and {emb.shape[0]} embeddings, "
                             f"the manifest says {manifest['n_docs']}")
        logger.info("Loaded sharded index (%d docs) from %s", len(self), out)

    # -- queries ----------------------------------------------------------------------

    def _query_vectors(self, queries: Sequence[str], dtype: torch.dtype) -> torch.Tensor:
        vecs = np.asarray(self.embedder.encode(queries))
        vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
        return self._to_device(vecs.astype(np.float32)).to(dtype)

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        pool: int = 50,
        router=None,
        exact: bool = False,
        sparse_mode: str = "twotier",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sharded hybrid search through the fused sharded query.

        (scores [B, k], global doc positions [B, k]), the same on every
        rank. Every top-k is exact; ``exact=False`` turns on the twotier
        ``lsel`` truncation of the low tier, as ``approx`` does in the JAX
        package. ``router`` is a ``RetrievalRouter`` on this rank's device.
        """
        state = self.sync()
        pool = min(pool, max(len(self), 1))
        top_k = min(top_k, 2 * pool)
        tt = state["twotier"]
        delta = state.get("delta")
        fused = make_fused_sharded_query(
            self.mesh,
            shard_cap=state["shard_cap"],
            router_module=router.module if router is not None else None,
            router_width=router.trained_num_passages if router is not None else None,
            k=top_k,
            pool=pool,
            beam=tt["beam"],
            approx_topk=not exact,
            sparse_mode=sparse_mode,
            lsel=self.bm25.config.lsel,
            nonneg=tt["nonneg"],
            delta_cap=delta["n_docs_cap"] if delta else 0,
            delta_max_df=delta["max_df"] if delta else 0,
        )
        qtids_raw = self.bm25.encode_queries(queries)
        # Terms first seen after the base layout exist only in the delta
        # CSR; they are clamped out of the base two-tier lookup.
        base_vcap = tt["term_row"].shape[0]
        qterms = {"qtids": self._to_device(np.where(qtids_raw < base_vcap, qtids_raw, -1))}
        fused_state = {
            "emb": state["emb"],
            **{name: tt[name] for name in (
                "low_ranges", "post_packed", "term_row", "impact", "impact_scale")},
            "size": len(self) if delta is None else delta["base_docs"],
        }
        if delta is not None:
            delta_vcap = delta["indptr"].shape[0] - 1
            qterms["qtids_full"] = self._to_device(
                np.where(qtids_raw < delta_vcap, qtids_raw, -1))
            fused_state.update(
                delta_emb=delta["emb"],
                delta_indptr=delta["indptr"],
                delta_post_doc=delta["post_doc"],
                delta_post_w=delta["post_w"],
                delta_size=len(self) - delta["base_docs"],
                delta_base_docs=delta["base_docs"],
            )
        vals, pos = fused(fused_state, self._query_vectors(queries, state["emb"].dtype), qterms)
        return vals.cpu().numpy(), pos.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def search_batch_unfused(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        pool: int = 50,
        router=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Three-searcher sharded hybrid search: the exact oracle twin.

        Exhaustive scatter-add BM25 per shard and the exact dense top-k,
        fused as the fused query's tail fuses them
        (``retrieval/fused.py::fuse_pools_select``, the router over every
        union column): slower, with no approximation. Always
        runs on a full layout (a pending delta forces the reshard), so it is
        also the fresh-statistics oracle for the delta's bounded staleness.
        """
        state = self.sync()
        if "delta" in state:
            state = self._sync_full()
        pool = min(pool, max(len(self), 1))
        dense_topk = make_sharded_dense_topk(self.mesh, k=pool)
        bm25_topk = make_sharded_bm25_topk(self.mesh, k=pool, max_df=state["max_df"],
                                           n_docs_cap=state["cap"])
        q = self._query_vectors(queries, torch.float32)
        qtids = self._to_device(self.bm25.encode_queries(queries))
        dvals, didx = dense_topk(state["emb"], q, len(self))
        b = state["bm25"]
        bvals, bidx = bm25_topk(b["indptr"], b["post_doc"], b["post_w"], qtids)

        vals, pos = fuse_pools_select(
            bvals, bidx, torch.where(didx >= 0, dvals, 0.0), didx, top_k,
            router_module=router.module if router is not None else None)
        return vals.cpu().numpy(), pos.cpu().numpy().astype(np.int32)
