"""Hybrid retriever: the counterpart of ``rag_uq_tpu/retrieval/hybrid.py::HybridRetriever``.

BM25 and dense indices on one device; the batched fused query over both
(``retrieval/fused.py``), whose default ``sparse_mode="twotier"`` is the JAX
package's, served from a live delta when ``delta_sync_fraction > 0``; and the
reference-parity paths: the union pool with exact rescoring
(``pooled_scores_batch``), ``hybrid_search``, ``get_scores_for_router`` and
its batched form. With ``bm25_persist_path``/``dense_persist_directory`` the
indices load what either package saved there.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document, RetrievalResult
from rag_uq_tpu_torch.embed.base import Embedder
from rag_uq_tpu_torch.index.dense import DenseIndex
from rag_uq_tpu_torch.index.sparse import BM25Index
from rag_uq_tpu_torch.retrieval.fused import (
    build_index_state,
    encode_for_fused,
    make_fused_hybrid_query,
    union_dedup,
)


class HybridRetriever:
    """Unified hybrid retrieval combining BM25 and dense search."""

    def __init__(
        self,
        bm25_persist_path: Optional[str] = None,
        dense_persist_directory: Optional[str] = None,
        embedder: Optional[Embedder] = None,
        bm25_config: Optional[BM25Config] = None,
        dense_config: Optional[DenseIndexConfig] = None,
        embedder_config: Optional[EmbedderConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.bm25_index = BM25Index(
            persist_path=bm25_persist_path, config=bm25_config, device=self.device
        )
        self.dense_index = DenseIndex(
            embedder=embedder, config=dense_config, embedder_config=embedder_config,
            persist_directory=dense_persist_directory, device=self.device,
        )
        # The two indices append in the same order, so row positions coincide.
        self.documents: DocStore = self.dense_index.store
        # Serializes the lazy fused-state rebuild across searcher threads.
        self._fused_lock = threading.RLock()
        self._fused_cache_key = None
        self._fused_state_cache = None

    def __len__(self) -> int:
        return len(self.documents)

    def add_documents(
        self, documents: Sequence[Document], batch_size: int = 256
    ) -> Dict[str, int]:
        stats = {
            "bm25_added": self.bm25_index.add_documents(documents),
            "dense_added": self.dense_index.add_documents(documents, batch_size),
        }
        stats["total_documents"] = len(self.documents)
        return stats

    # -- single-method search ------------------------------------------------------

    def bm25_search(self, query: str, top_k: int = 20) -> List[Tuple[str, float]]:
        return self.bm25_index.search(query, top_k)

    def dense_search(self, query: str, top_k: int = 20) -> List[Tuple[str, float]]:
        return [(doc_id, score) for doc_id, score, _ in self.dense_index.search(query, top_k)]

    # -- batched union pool ----------------------------------------------------------

    def pooled_scores_batch(
        self,
        queries: Sequence[str],
        pool_size: int = 50,
        exact_bm25: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Union-pool doc positions and aligned exact scores for a batch.

        Returns (positions [B, 2*pool], bm25 [B, 2*pool], dense [B, 2*pool]);
        position -1 marks dead slots (deduped or missing), whose scores are 0.
        Both scores of every member are exact (not the reference's 0.0 for a
        doc missing from one pool).
        """
        pool = min(pool_size, max(len(self.documents), 1))
        q_vecs = self.dense_index.embed_queries(queries)
        qtids = self.bm25_index.encode_queries(queries)
        _, b_pos = self.bm25_index.search_batch(
            queries, top_k=pool, exact=exact_bm25, qtids=qtids
        )
        _, d_pos = self.dense_index.search_batch(queries, top_k=pool, q_vecs=q_vecs)
        cat = torch.from_numpy(np.concatenate([b_pos, d_pos], axis=1).astype(np.int32))
        positions = union_dedup(cat).numpy()
        bm25 = np.array(self.bm25_index.score_positions_batch(queries, positions, qtids=qtids))
        dense = np.array(
            self.dense_index.score_positions_batch(queries, positions, q_vecs=q_vecs)
        )
        dead = positions < 0
        bm25[dead] = 0.0
        dense[dead] = 0.0
        return positions, bm25, dense

    # -- fused batched path --------------------------------------------------------

    def _cache_key(self):
        bm25 = self.bm25_index
        return (len(self.dense_index), bm25._n_postings, bm25.sync_generation, bm25._dirty)

    def _fused_state(self):
        """The fused query's index state, rebuilt when either index changed;
        delta-synced when ``delta_sync_fraction > 0``."""
        if self._fused_cache_key != self._cache_key():
            with self._fused_lock:
                if self._fused_cache_key != self._cache_key():
                    self._fused_state_cache = build_index_state(
                        self.dense_index, self.bm25_index,
                        allow_delta=self.bm25_index.config.delta_sync_fraction > 0,
                    )
                    # Keyed after the build: the sync bumps the generation.
                    self._fused_cache_key = self._cache_key()
        return self._fused_state_cache

    def hybrid_search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        retrieval_pool_size: int = 50,
        router=None,
        approx: bool = True,
        sparse_mode: str = "twotier",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched hybrid search through the fused query.

        Returns (scores [B, k], doc positions [B, k]); -1 marks dead slots.
        ``router`` is an optional ``RetrievalRouter`` whose gate replaces the
        fixed fusion (clamped to its trained width). Every top-k is exact
        (``approx`` has no PyTorch counterpart; it only turns on the twotier
        ``lsel`` truncation, as in the JAX package). ``sparse_mode`` selects
        the BM25 pool op, "twotier" (the default) or "scatter".
        """
        pool = min(retrieval_pool_size, max(len(self.documents), 1))
        state = self._fused_state()
        dev = self.bm25_index._device
        delta = self.bm25_index._delta_device
        fused = make_fused_hybrid_query(
            router_module=router.module if router is not None else None,
            router_width=router.trained_num_passages if router is not None else None,
            k=min(top_k, 2 * pool),
            pool=pool,
            beam=dev["beam"],
            approx_topk=approx,
            nonneg=dev["nonneg"],
            delta_cap=delta["n_docs_cap"] if delta is not None else 0,
            delta_max_df=delta["max_df"] if delta is not None else 0,
            sparse_mode=sparse_mode,
            lsel=self.bm25_index.config.lsel,
        )
        q_vecs = self.dense_index.embed_queries(queries)
        qterms = encode_for_fused(
            self.bm25_index, queries, active_compaction=(sparse_mode == "scatter")
        )
        vals, pos = fused(state, q_vecs, qterms)
        return vals.cpu().numpy(), pos.cpu().numpy().astype(np.int32)

    # -- hybrid search --------------------------------------------------------------

    def hybrid_search(
        self,
        query: str,
        top_k: int = 10,
        retrieval_pool_size: int = 50,
    ) -> List[RetrievalResult]:
        """Union pool -> max-normalize each column -> rank by mean score."""
        if len(self.documents) == 0:
            return []
        positions, bm25, dense = self.pooled_scores_batch(
            [query], pool_size=retrieval_pool_size
        )
        positions, bm25, dense = positions[0], bm25[0], dense[0]
        live = positions >= 0
        if not live.any():
            return []
        # Non-positive column maxima are possible with exact union scores;
        # dividing by a negative max would invert the ranking.
        max_bm25 = max(float(bm25[live].max()), 1e-12)
        max_dense = max(float(dense[live].max()), 1e-12)
        results = []
        for pos, bs, ds in zip(positions[live], bm25[live], dense[live]):
            doc = self.documents.document_at(int(pos))
            results.append(
                RetrievalResult(
                    doc_id=doc.id,
                    text=doc.text,
                    bm25_score=float(bs),
                    dense_score=float(ds),
                    hybrid_score=float(bs / max_bm25 + ds / max_dense) / 2,
                    title=doc.title,
                    metadata=doc.metadata,
                )
            )
        results.sort(key=lambda r: r.hybrid_score or 0, reverse=True)
        return results[:top_k]

    def get_scores_for_router(
        self, query: str, num_passages: int = 20
    ) -> Tuple[List[float], List[float], List[str], List[str]]:
        """Aligned zero-padded score arrays for the router."""
        results = self.hybrid_search(query, top_k=num_passages)
        bm25_scores = [r.bm25_score for r in results]
        dense_scores = [r.dense_score for r in results]
        doc_ids = [r.doc_id for r in results]
        texts = [r.text for r in results]
        while len(bm25_scores) < num_passages:
            bm25_scores.append(0.0)
            dense_scores.append(0.0)
            doc_ids.append("")
            texts.append("")
        return bm25_scores, dense_scores, doc_ids, texts

    def get_scores_for_router_batch(
        self,
        queries: Sequence[str],
        num_passages: int = 20,
        retrieval_pool_size: int = 50,
        pool_order: str = "fused",
    ) -> Tuple[np.ndarray, np.ndarray, List[List[str]], List[List[str]]]:
        """Batched ``get_scores_for_router``: the per-query union pool, fixed
        fusion ranking, the top ``num_passages`` rows with raw scores,
        zero-padded.

        ``pool_order`` picks which members are kept when the pool is wider
        than the output: "fused" (the head of the fixed mean-fusion ranking)
        or "balanced" (each candidate by its best single-tower rank, the
        fused score breaking ties, then presented in fixed-fusion order).
        The ordering is the JAX package's numpy code, unchanged.

        Returns (bm25 [B, P], dense [B, P], doc_ids [B][P], texts [B][P]).
        """
        if len(self.documents) == 0 or not queries:
            bsz = len(queries)
            empty = np.zeros((bsz, num_passages), dtype=np.float64)
            pads = [[""] * num_passages for _ in range(bsz)]
            return empty, empty.copy(), pads, [r[:] for r in pads]
        positions, bm25, dense = self.pooled_scores_batch(
            list(queries), pool_size=retrieval_pool_size
        )
        live = positions >= 0
        max_b = np.maximum(np.where(live, bm25, -np.inf).max(axis=1), 1e-12)
        max_d = np.maximum(np.where(live, dense, -np.inf).max(axis=1), 1e-12)
        fused = (bm25 / max_b[:, None] + dense / max_d[:, None]) / 2.0
        fused = np.where(live, fused, -np.inf)
        if pool_order == "balanced":
            big = bm25.shape[1] + 1
            rank_b = np.argsort(np.argsort(-np.where(live, bm25, -np.inf), axis=1), axis=1)
            rank_d = np.argsort(np.argsort(-np.where(live, dense, -np.inf), axis=1), axis=1)
            min_rank = np.where(live, np.minimum(rank_b, rank_d), big)
            # Primary: best single-tower rank; secondary: fused score.
            sel = np.lexsort((-fused, min_rank), axis=1)[:, :num_passages]
            sel_fused = np.take_along_axis(fused, sel, axis=1)
            order = np.take_along_axis(sel, np.argsort(-sel_fused, axis=1), axis=1)
        else:
            order = np.argsort(-fused, axis=1)[:, :num_passages]

        sel_pos = np.take_along_axis(positions, order, axis=1)
        sel_b = np.take_along_axis(bm25, order, axis=1)
        sel_d = np.take_along_axis(dense, order, axis=1)
        dead = sel_pos < 0
        sel_b = np.where(dead, 0.0, sel_b)
        sel_d = np.where(dead, 0.0, sel_d)
        pad = num_passages - sel_pos.shape[1]
        if pad > 0:
            sel_pos = np.pad(sel_pos, ((0, 0), (0, pad)), constant_values=-1)
            sel_b = np.pad(sel_b, ((0, 0), (0, pad)))
            sel_d = np.pad(sel_d, ((0, 0), (0, pad)))
        store = self.documents
        doc_ids = [[store.ids[int(p)] if p >= 0 else "" for p in row] for row in sel_pos]
        texts = [[store.texts[int(p)] if p >= 0 else "" for p in row] for row in sel_pos]
        return sel_b, sel_d, doc_ids, texts
