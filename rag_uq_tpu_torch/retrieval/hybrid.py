"""Hybrid retriever: the counterpart of ``rag_uq_tpu/retrieval/hybrid.py::HybridRetriever``.

BM25 and dense indices on one device, and the batched fused query over both
(``retrieval/fused.py``). The single-query reference-parity paths
(``hybrid_search``, ``get_scores_for_router``) and persistence wait for a
later slice.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document
from rag_uq_tpu_torch.embed.base import Embedder
from rag_uq_tpu_torch.index.dense import DenseIndex
from rag_uq_tpu_torch.index.sparse import BM25Index
from rag_uq_tpu_torch.retrieval.fused import (
    build_index_state,
    encode_for_fused,
    make_fused_hybrid_query,
)


class HybridRetriever:
    """Unified hybrid retrieval combining BM25 and dense search."""

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        bm25_config: Optional[BM25Config] = None,
        dense_config: Optional[DenseIndexConfig] = None,
        embedder_config: Optional[EmbedderConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.bm25_index = BM25Index(config=bm25_config, device=self.device)
        self.dense_index = DenseIndex(
            embedder=embedder, config=dense_config,
            embedder_config=embedder_config, device=self.device,
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

    def _cache_key(self):
        bm25 = self.bm25_index
        return (len(self.dense_index), bm25._n_postings, bm25.sync_generation, bm25._dirty)

    def _fused_state(self):
        """The fused query's index state, rebuilt when either index changed."""
        if self._fused_cache_key != self._cache_key():
            with self._fused_lock:
                if self._fused_cache_key != self._cache_key():
                    self._fused_state_cache = build_index_state(
                        self.dense_index, self.bm25_index
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
        fixed fusion. Every top-k is exact (``approx`` has no PyTorch
        counterpart). The default ``sparse_mode="twotier"`` is the JAX
        package's default and waits for the next slice: it raises
        ``NotImplementedError``; pass ``"scatter"``.
        """
        pool = min(retrieval_pool_size, max(len(self.documents), 1))
        k = min(top_k, 2 * pool)
        state = self._fused_state()
        fused = make_fused_hybrid_query(
            router_module=router.module if router is not None else None,
            router_width=router.trained_num_passages if router is not None else None,
            k=k,
            pool=pool,
            beam=self.bm25_index._device["beam"],
            approx_topk=approx,
            sparse_mode=sparse_mode,
        )
        q_vecs = self.dense_index.embed_queries(queries)
        qterms = encode_for_fused(
            self.bm25_index, queries, active_compaction=(sparse_mode == "scatter")
        )
        vals, pos = fused(state, q_vecs, qterms)
        return vals.cpu().numpy(), pos.cpu().numpy().astype(np.int32)
