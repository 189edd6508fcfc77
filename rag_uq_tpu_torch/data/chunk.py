"""Sliding-window text chunking.

A copy of ``rag_uq_tpu/data/chunk.py`` (numpy only), held to it by
``tests/test_torch_data.py``.

Behavioral parity with the reference's chunker
(data/preprocessing/prepare_corpus.py:37-78): whitespace-normalized text,
word windows of `chunk_size` advancing by `chunk_size - overlap`; texts
shorter than chunk_size/2 words pass through whole (or drop if under
`min_chunk_length` characters); chunks under `min_chunk_length` characters
are dropped and chunks over `max_chunk_length` characters truncated.
"""

from __future__ import annotations

import re
from typing import List, Optional

from rag_uq_tpu_torch.core.config import ChunkConfig


def chunk_text(text: str, config: Optional[ChunkConfig] = None) -> List[str]:
    """Split text into overlapping word-window chunks."""
    cfg = config or ChunkConfig()
    text = re.sub(r"\s+", " ", text).strip()
    words = text.split()

    if len(words) < cfg.chunk_size // 2:
        return [text] if len(text) >= cfg.min_chunk_size else []

    step = max(cfg.chunk_size - cfg.overlap, 1)
    chunks: List[str] = []
    for i in range(0, len(words), step):
        chunk = " ".join(words[i : i + cfg.chunk_size])
        if len(chunk) >= cfg.min_chunk_size:
            chunks.append(chunk[: cfg.max_chunk_chars])
        if i + cfg.chunk_size >= len(words):
            break
    return chunks
