"""Dense index: the counterpart of ``rag_uq_tpu/index/dense.py::DenseIndex``.

The corpus lives on the device as a preallocated, L2-normalized
``[capacity, D]`` matrix in ``DenseIndexConfig.dtype`` (bf16 by default);
capacity is a multiple of ``score_block`` and doubles when an append needs
more. Rows at or past ``len(index)`` are dead everywhere (size-masked).

The stored width is the embedding width zero-padded to a multiple of 8, the
row alignment the cosine top-k kernel's TMA loads need; ``embed_queries``
pads the query vectors alike. Zero columns change no product. The true width
stays in ``config.embedding_dim``, ``embeddings`` and what ``save`` writes.

``search_batch`` runs the cosine top-k kernel on a CUDA tensor and the
block-streamed plain twin (``ops/topk.py::cosine_topk``, as the JAX index
does) on the CPU. ``save``/``_load`` use the JAX package's format
(``embeddings.npy`` f32, ``docs.jsonl``, ``meta.json`` with the tokenizer
version), so either package loads what the other saved.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import DenseIndexConfig, EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document
from rag_uq_tpu_torch.embed.base import Embedder, get_embedder
from rag_uq_tpu_torch.ops.cosine_topk import cuda_cosine_topk
from rag_uq_tpu_torch.ops.topk import cosine_topk, gather_scores
from rag_uq_tpu_torch.text.tokenize import TOKENIZER_VERSION

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _normalize(vecs: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs / np.maximum(norms, 1e-12)


def padded_width(dim: int) -> int:
    """The stored feature width: ``dim`` rounded up to a multiple of 8."""
    return -(-dim // 8) * 8


class DenseIndex:
    """Exact dense retrieval over an on-device embedding matrix."""

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        config: Optional[DenseIndexConfig] = None,
        embedder_config: Optional[EmbedderConfig] = None,
        persist_directory: Optional[str] = None,
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
        self.persist_directory = Path(persist_directory) if persist_directory else None
        self.store = DocStore()
        block = self.config.score_block
        cap = max(self.config.initial_capacity, block)
        cap = -(-cap // block) * block
        self._emb = torch.zeros(
            (cap, padded_width(self.config.embedding_dim)),
            dtype=_DTYPES[self.config.dtype], device=self.device,
        )
        self._size = 0

        if self.persist_directory and (self.persist_directory / "meta.json").exists():
            self._load()

    def __len__(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return int(self._emb.shape[0])

    @property
    def embeddings(self) -> torch.Tensor:
        """The live [size, D] rows at the true width (a view of the matrix)."""
        return self._emb[: self._size, : self.config.embedding_dim]

    def _padded(self, vecs: torch.Tensor) -> torch.Tensor:
        """Zero columns up to the stored width."""
        extra = self._emb.shape[1] - vecs.shape[1]
        return torch.nn.functional.pad(vecs, (0, extra)) if extra else vecs

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
        self._emb[offset : offset + rows.shape[0], : rows.shape[1]] = rows.to(
            self.device
        ).to(self._emb.dtype)

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
        """L2-normalized query vectors [B, D_stored] f32 on the index's
        device, zero-padded to the stored width."""
        vecs = _normalize(self.embedder.encode(queries))
        return self._padded(
            torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(self.device)
        )

    def _query_vectors(self, queries: Sequence[str], q_vecs) -> torch.Tensor:
        if q_vecs is None:
            return self.embed_queries(queries)
        return self._padded(torch.as_tensor(q_vecs, dtype=torch.float32, device=self.device))

    def search_batch(
        self, queries: Sequence[str], top_k: int = 10, q_vecs=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched exact top-k: (scores [B, k], doc positions [B, k]);
        -inf and -1 in dead slots."""
        q = self._query_vectors(queries, q_vecs)
        if self._emb.device.type == "cuda":
            vals, idx = cuda_cosine_topk(self._emb, q, self._size, top_k)
        else:
            vals, idx = cosine_topk(self._emb, q, self._size, top_k, self.config.score_block)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search(self, query: str, top_k: int = 10) -> List[Tuple[str, float, str]]:
        """Single-query search -> [(doc_id, cosine score, text)]."""
        if self._size == 0:
            return []
        vals, idx = self.search_batch([query], top_k=min(top_k, self._size))
        return [
            (self.store.ids[int(pos)], float(score), self.store.texts[int(pos)])
            for score, pos in zip(vals[0], idx[0])
            if pos >= 0
        ]

    def score_positions_batch(
        self, queries: Sequence[str], positions: np.ndarray, q_vecs=None
    ) -> np.ndarray:
        """Cosine scores for specific doc positions [B, P] (-1 -> 0.0)."""
        q = self._query_vectors(queries, q_vecs)
        pos = torch.from_numpy(np.ascontiguousarray(positions, dtype=np.int64)).to(self.device)
        return gather_scores(self._emb, q, pos).cpu().numpy()

    # -- persistence -----------------------------------------------------------

    def save(self, directory: Optional[str] = None) -> None:
        out = Path(directory) if directory else self.persist_directory
        if out is None:
            raise ValueError("No persist directory configured")
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "embeddings.npy", self.embeddings.float().cpu().numpy())
        with open(out / "docs.jsonl", "w") as f:
            for i in range(len(self.store)):
                f.write(json.dumps({
                    "id": self.store.ids[i],
                    "text": self.store.texts[i],
                    "title": self.store.titles[i],
                    "metadata": self.store.metadatas[i],
                }) + "\n")
        with open(out / "meta.json", "w") as f:
            json.dump({
                "size": self._size,
                "dim": self.config.embedding_dim,
                # The stored vectors bake in the build-time tokenization.
                "tokenizer": TOKENIZER_VERSION,
            }, f)
        logger.info("Saved dense index (%d rows) to %s", self._size, out)

    def _load(self) -> None:
        out = self.persist_directory
        with open(out / "meta.json") as f:
            meta = json.load(f)
        saved_tok = meta.get("tokenizer", "v1-bare-split")
        if saved_tok != TOKENIZER_VERSION:
            msg = (
                f"Dense index {out} was built with tokenizer {saved_tok} "
                f"(current: {TOKENIZER_VERSION}); query embeddings will not "
                "match the stored document vectors — rebuild the index"
            )
            if not self.config.allow_tokenizer_mismatch:
                raise ValueError(
                    msg + " (or set DenseIndexConfig."
                    "allow_tokenizer_mismatch=True to load anyway)"
                )
            logger.warning("%s", msg)
        vecs = np.load(out / "embeddings.npy")
        docs = []
        with open(out / "docs.jsonl") as f:
            for line in f:
                d = json.loads(line)
                docs.append(Document(d["id"], d["text"], d.get("title"), d.get("metadata")))
        self.add_precomputed(docs, vecs)
        if self._size != meta["size"]:
            raise ValueError(f"dense index {out}: {self._size} rows loaded, meta says {meta['size']}")
        logger.info("Loaded dense index with %d rows", self._size)
