"""Dense index: the counterpart of ``rag_uq_tpu/index/dense.py::DenseIndex``.

The corpus lives on the device as a preallocated, L2-normalized
``[capacity, D]`` matrix in ``DenseIndexConfig.dtype`` (bf16 by default);
capacity is a multiple of ``score_block`` and doubles when an append needs
more. Rows at or past ``len(index)`` are dead everywhere (size-masked).
Search goes through the fused query (``retrieval/fused.py``). Persistence
waits for a later slice.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document
from rag_uq_tpu_torch.embed.base import Embedder, get_embedder

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _normalize(vecs: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs / np.maximum(norms, 1e-12)


class DenseIndex:
    """Exact dense retrieval over an on-device embedding matrix."""

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        config: Optional[DenseIndexConfig] = None,
        embedder_config: Optional[EmbedderConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.config = config or DenseIndexConfig()
        self.device = resolve_device(device)
        self.embedder = embedder or get_embedder(
            embedder_config or EmbedderConfig(dim=self.config.embedding_dim),
            device=self.device,
        )
        if self.embedder.dim != self.config.embedding_dim:
            self.config.embedding_dim = self.embedder.dim
        self.store = DocStore()
        block = self.config.score_block
        cap = max(self.config.initial_capacity, block)
        cap = -(-cap // block) * block
        self._emb = torch.zeros(
            (cap, self.config.embedding_dim),
            dtype=_DTYPES[self.config.dtype], device=self.device,
        )
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return int(self._emb.shape[0])

    # -- build -----------------------------------------------------------------

    def _grow(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        grown = torch.zeros(
            (new_cap, self._emb.shape[1]), dtype=self._emb.dtype, device=self.device
        )
        grown[: self.capacity] = self._emb
        self._emb = grown
        logger.info("Grew dense index capacity to %d rows", new_cap)

    def _write(self, offset: int, vecs: np.ndarray) -> None:
        rows = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32))
        self._emb[offset : offset + rows.shape[0]] = rows.to(self.device).to(
            self._emb.dtype
        )

    def add_documents(
        self, documents: Sequence[Document], batch_size: int = 256
    ) -> int:
        """Embed and append new documents (dedup by id). Returns count added.

        Every batch is padded to ``batch_size`` with empty texts, as the JAX
        index does; the padded rows land past ``len(self)`` and are dead.
        """
        seen = {}
        for doc in documents:
            if doc.id not in self.store and doc.id not in seen:
                seen[doc.id] = doc
        new_docs = list(seen.values())
        if not new_docs:
            return 0
        n_pad_total = -(-len(new_docs) // batch_size) * batch_size
        self._grow(self._size + n_pad_total)
        for i in range(0, len(new_docs), batch_size):
            batch = new_docs[i : i + batch_size]
            texts = [d.text for d in batch]
            texts += [""] * (batch_size - len(batch))
            vecs = self.embedder.encode(texts)
            if self.config.normalize:
                vecs = _normalize(vecs)
            self._write(self._size, vecs)
            for d in batch:
                self.store.append(d)
            self._size += len(batch)
        logger.info("Dense index: added %d docs, total %d", len(new_docs), self._size)
        return len(new_docs)

    def add_precomputed(
        self, documents: Sequence[Document], vectors: np.ndarray
    ) -> int:
        """Append documents with externally computed embeddings."""
        keep = [i for i, d in enumerate(documents) if d.id not in self.store]
        if not keep:
            return 0
        vecs = np.asarray(vectors, dtype=np.float32)[keep]
        if self.config.normalize:
            vecs = _normalize(vecs)
        self._grow(self._size + len(keep))
        self._write(self._size, vecs)
        for i in keep:
            self.store.append(documents[i])
        self._size += len(keep)
        return len(keep)

    # -- queries ---------------------------------------------------------------

    def embed_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """L2-normalized query vectors [B, D] f32 on the index's device."""
        vecs = _normalize(self.embedder.encode(queries))
        return torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(
            self.device
        )
