"""Clean-room implementations of the third-party packages the reference
imports (`rank_bm25`, `chromadb`), so the parity harness can run the
reference's own code unmodified without network access. A copy of
``rag_uq_tpu/compat/shims.py``: the port imports nothing of the JAX package.

These implement the packages' PUBLIC APIs from their documentation/published
algorithms — no reference code involved:

- `BM25Okapi`: the published Okapi BM25 formula exactly as the rank_bm25
  package computes it (idf = ln((N-df+0.5)/(df+0.5)), strictly-negative idfs
  floored at epsilon * mean(idf), per-occurrence query-term scoring).
- `chromadb`: an in-memory vector collection with exact cosine distance
  (distance = 1 - cosine). The real package uses HNSW (approximate); exact
  search can only make the reference arm look BETTER in a retrieval
  head-to-head, so parity conclusions drawn against it are conservative.

`install_shims()` registers them in sys.modules ONLY when the real packages
are absent.
"""

from __future__ import annotations

import sys
import types
from typing import Dict, List, Optional, Sequence

import numpy as np


# -- rank_bm25 ---------------------------------------------------------------------


class BM25Okapi:
    """Okapi BM25 (published formula; API-compatible with rank_bm25)."""

    def __init__(
        self,
        corpus: Sequence[Sequence[str]],
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
    ):
        self.k1, self.b, self.epsilon = k1, b, epsilon
        self.corpus_size = len(corpus)
        self.doc_len = np.array([len(d) for d in corpus], dtype=np.float64)
        self.avgdl = self.doc_len.mean() if self.corpus_size else 0.0

        self.doc_freqs: List[Dict[str, int]] = []
        df: Dict[str, int] = {}
        for doc in corpus:
            freqs: Dict[str, int] = {}
            for tok in doc:
                freqs[tok] = freqs.get(tok, 0) + 1
            self.doc_freqs.append(freqs)
            for tok in freqs:
                df[tok] = df.get(tok, 0) + 1

        self.idf: Dict[str, float] = {}
        negative = []
        total = 0.0
        for tok, f in df.items():
            val = np.log(self.corpus_size - f + 0.5) - np.log(f + 0.5)
            self.idf[tok] = val
            total += val
            if val < 0:
                negative.append(tok)
        avg_idf = total / len(self.idf) if self.idf else 0.0
        eps = epsilon * avg_idf
        for tok in negative:
            self.idf[tok] = eps

    def get_scores(self, query: Sequence[str]) -> np.ndarray:
        scores = np.zeros(self.corpus_size, dtype=np.float64)
        norm = self.k1 * (1 - self.b + self.b * self.doc_len / max(self.avgdl, 1e-12))
        for tok in query:
            idf = self.idf.get(tok)
            if idf is None:
                continue
            tf = np.array(
                [freqs.get(tok, 0) for freqs in self.doc_freqs], dtype=np.float64
            )
            scores += idf * tf * (self.k1 + 1) / (tf + norm)
        return scores

    def get_top_n(
        self, query: Sequence[str], documents: Sequence, n: int = 5
    ) -> List:
        scores = self.get_scores(query)
        top = np.argsort(scores)[::-1][:n]
        return [documents[i] for i in top]


# -- chromadb ---------------------------------------------------------------------


class _Collection:
    """In-memory exact-cosine vector collection (chromadb Collection API)."""

    def __init__(self, name: str, metadata: Optional[dict] = None):
        self.name = name
        self.metadata = metadata or {}
        self._ids: List[str] = []
        self._pos: Dict[str, int] = {}
        self._embs: List[np.ndarray] = []
        self._docs: List[str] = []
        self._metas: List[dict] = []

    def add(self, ids, embeddings, documents=None, metadatas=None) -> None:
        documents = documents or [""] * len(ids)
        metadatas = metadatas or [{}] * len(ids)
        for i, doc_id in enumerate(ids):
            emb = np.asarray(embeddings[i], dtype=np.float64)
            if doc_id in self._pos:  # upsert semantics
                p = self._pos[doc_id]
                self._embs[p], self._docs[p] = emb, documents[i]
                self._metas[p] = metadatas[i]
                continue
            self._pos[doc_id] = len(self._ids)
            self._ids.append(doc_id)
            self._embs.append(emb)
            self._docs.append(documents[i])
            self._metas.append(metadatas[i])

    def get(self, ids=None, include=None) -> dict:
        if ids is None:
            return {"ids": list(self._ids)}
        found = [i for i in ids if i in self._pos]
        return {"ids": found}

    def count(self) -> int:
        return len(self._ids)

    def query(self, query_embeddings, n_results: int = 10, include=None) -> dict:
        if not self._ids:
            empty = [[] for _ in query_embeddings]
            return {"ids": empty, "distances": [list(e) for e in empty],
                    "documents": [list(e) for e in empty],
                    "metadatas": [list(e) for e in empty]}
        matrix = np.stack(self._embs)  # [N, D]
        norms = np.linalg.norm(matrix, axis=1)
        out_ids, out_dist, out_docs, out_metas = [], [], [], []
        for q in query_embeddings:
            q = np.asarray(q, dtype=np.float64)
            qn = np.linalg.norm(q)
            cos = (matrix @ q) / np.maximum(norms * qn, 1e-12)
            order = np.argsort(-cos)[:n_results]
            out_ids.append([self._ids[i] for i in order])
            # cosine space: distance = 1 - cosine similarity
            out_dist.append([float(1.0 - cos[i]) for i in order])
            out_docs.append([self._docs[i] for i in order])
            out_metas.append([self._metas[i] for i in order])
        return {"ids": out_ids, "distances": out_dist,
                "documents": out_docs, "metadatas": out_metas}


class _Client:
    def __init__(self):
        self._collections: Dict[str, _Collection] = {}

    def get_or_create_collection(self, name: str, metadata=None) -> _Collection:
        if name not in self._collections:
            self._collections[name] = _Collection(name, metadata)
        return self._collections[name]

    def delete_collection(self, name: str) -> None:
        self._collections.pop(name, None)


def _make_chromadb_module() -> types.ModuleType:
    mod = types.ModuleType("chromadb")

    def PersistentClient(path=None, settings=None):  # noqa: N802 (API name)
        return _Client()

    def HttpClient(host=None, port=None, settings=None):  # noqa: N802
        return _Client()

    mod.PersistentClient = PersistentClient
    mod.HttpClient = HttpClient
    mod.Client = lambda *a, **k: _Client()
    config = types.ModuleType("chromadb.config")
    config.Settings = lambda **kwargs: dict(kwargs)
    mod.config = config
    sys.modules["chromadb.config"] = config
    return mod


def _make_rank_bm25_module() -> types.ModuleType:
    mod = types.ModuleType("rank_bm25")
    mod.BM25Okapi = BM25Okapi
    return mod


def install_shims(force: bool = False) -> List[str]:
    """Register the shims for any missing package. Returns what was shimmed."""
    installed = []
    for name, maker in (
        ("rank_bm25", _make_rank_bm25_module),
        ("chromadb", _make_chromadb_module),
    ):
        if force or name not in sys.modules:
            try:
                if not force:
                    __import__(name)
                    continue  # real package present
            except ImportError:
                pass
            sys.modules[name] = maker()
            installed.append(name)
    return installed
