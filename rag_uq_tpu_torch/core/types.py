"""Core data types: copies of ``rag_uq_tpu/core/types.py``.

Behavioral parity with the reference's `Document` and `RetrievalResult`
(reference: rag_uq/streaming_index.py:54-89), and the host-side `DocStore`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Document:
    """A document for indexing (reference: streaming_index.py:54-77)."""

    id: str
    text: str
    title: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "text": self.text,
            "title": self.title or "",
            "metadata": self.metadata or {},
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Document":
        return cls(
            id=data["id"],
            text=data["text"],
            title=data.get("title"),
            metadata=data.get("metadata"),
        )


@dataclass
class RetrievalResult:
    """Result from hybrid retrieval (reference: streaming_index.py:80-89)."""

    doc_id: str
    text: str
    bm25_score: float
    dense_score: float
    hybrid_score: Optional[float] = None
    title: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None


@dataclass
class QueryBatchResult:
    """Device-side batched retrieval result (array-of-structs).

    `indices` are positions into the index's document table; `-1` marks an
    invalid slot (fewer than k live hits).
    """

    scores: np.ndarray  # [B, K] float32
    indices: np.ndarray  # [B, K] int32

    def __post_init__(self) -> None:
        self.scores = np.asarray(self.scores)
        self.indices = np.asarray(self.indices)

    @property
    def batch_size(self) -> int:
        return int(self.scores.shape[0])

    @property
    def k(self) -> int:
        return int(self.scores.shape[1])


@dataclass
class DocStore:
    """Host-side table mapping dense row positions -> document payloads.

    The device indices returned by the retrieval kernels are positions into
    this table. Append-only, mirroring the device index's append order.
    """

    ids: List[str] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)
    titles: List[Optional[str]] = field(default_factory=list)
    metadatas: List[Optional[Dict[str, Any]]] = field(default_factory=list)
    _id_to_pos: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.ids)

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._id_to_pos

    def position(self, doc_id: str) -> Optional[int]:
        return self._id_to_pos.get(doc_id)

    def append(self, doc: Document) -> int:
        """Append a document; returns its row position."""
        pos = len(self.ids)
        self.ids.append(doc.id)
        self.texts.append(doc.text)
        self.titles.append(doc.title)
        self.metadatas.append(doc.metadata)
        self._id_to_pos[doc.id] = pos
        return pos

    def get(self, doc_id: str) -> Optional[Document]:
        pos = self._id_to_pos.get(doc_id)
        if pos is None:
            return None
        return self.document_at(pos)

    def document_at(self, pos: int) -> Document:
        return Document(
            id=self.ids[pos],
            text=self.texts[pos],
            title=self.titles[pos],
            metadata=self.metadatas[pos],
        )
