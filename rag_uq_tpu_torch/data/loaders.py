"""Corpus and QA dataset loaders / writers / synthetic generators: a copy
of ``rag_uq_tpu/data/loaders.py`` (numpy only), held to it by
``tests/test_torch_data.py``. The original's ``prepare_natural_questions``
(a HuggingFace download with fallbacks) is not copied: the port reads
local JSONL only.

Capability parity with the reference's data pipeline
(data/preprocessing/prepare_corpus.py):

- `prepare_passages` (:239-293): article JSONL -> chunked passage JSONL with
  `{page_id}_{chunk_index}` ids, titles, and source metadata; malformed
  lines skipped.
- `create_synthetic_nq` (:424-472): deterministic seeded template QA.
- Synthetic router training data (experiments/run_router_training.py:240-307
  semantics): alternating BM25-favoring / dense-favoring relevance.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from rag_uq_tpu_torch.core.config import ChunkConfig
from rag_uq_tpu_torch.data.chunk import chunk_text

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# JSONL helpers
# ---------------------------------------------------------------------------


def read_jsonl(path: str, skip_bad: bool = True) -> Iterator[Dict]:
    """Yield JSON objects per line, skipping malformed lines with a warning."""
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as e:
                if not skip_bad:
                    raise
                logger.warning("Skipping invalid JSONL line %d: %s", i, e)


def write_jsonl(path: str, rows: List[Dict]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


# ---------------------------------------------------------------------------
# Passage preparation
# ---------------------------------------------------------------------------


def prepare_passages(
    input_file: str,
    output_file: str,
    chunk_config: Optional[ChunkConfig] = None,
) -> int:
    """Chunk article JSONL ({title, extract, page_id, url}) into passages."""
    cfg = chunk_config or ChunkConfig()
    out_path = Path(output_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    total = 0
    with open(out_path, "w") as fout:
        for line_num, article in enumerate(read_jsonl(input_file)):
            chunks = chunk_text(article.get("extract", ""), cfg)
            for i, chunk in enumerate(chunks):
                fout.write(
                    json.dumps(
                        {
                            "id": f"{article.get('page_id', line_num)}_{i}",
                            "text": chunk,
                            "title": article.get("title", ""),
                            "metadata": {
                                "source": "wikipedia",
                                "url": article.get("url", ""),
                                "chunk_index": i,
                                "total_chunks": len(chunks),
                            },
                        }
                    )
                    + "\n"
                )
                total += 1
    logger.info("Created %d passages from %s", total, input_file)
    return total


# ---------------------------------------------------------------------------
# QA datasets
# ---------------------------------------------------------------------------


def load_qa_jsonl(path: str, limit: Optional[int] = None) -> List[Dict]:
    """Load {question, answers, context} QA rows."""
    rows = []
    for row in read_jsonl(path):
        if "question" in row:
            rows.append(row)
        if limit and len(rows) >= limit:
            break
    return rows


def create_synthetic_nq(
    output_path: str, n_samples: int = 500, seed: int = 0
) -> int:
    """Seeded synthetic template QA (parity: prepare_corpus.py:424-472,
    made deterministic via an explicit seed)."""
    templates = [
        ("What is the capital of {country}?", "{capital}",
         "The capital of {country} is {capital}."),
        ("Who wrote {book}?", "{author}", "{author} wrote {book} in {year}."),
        ("When was {event}?", "{year}", "{event} occurred in {year}."),
        ("What is {concept}?", "{definition}", "{concept} is {definition}."),
    ]
    data = [
        {"country": "France", "capital": "Paris"},
        {"country": "Germany", "capital": "Berlin"},
        {"country": "Japan", "capital": "Tokyo"},
        {"book": "1984", "author": "George Orwell", "year": "1949"},
        {"book": "Pride and Prejudice", "author": "Jane Austen", "year": "1813"},
        {"event": "World War II", "year": "1939-1945"},
        {"concept": "Machine Learning", "definition": "a type of artificial intelligence"},
        {"concept": "RAG", "definition": "Retrieval-Augmented Generation"},
    ]
    # Unlike the reference (which samples template/item pairs blindly and
    # skips incompatible combinations, yielding fewer rows than asked), pair
    # each template with its compatible items so exactly n_samples rows come
    # out, deterministically.
    import string

    def fields(t: str) -> set:
        return {f for _, f, _, _ in string.Formatter().parse(t) if f}

    compat = [
        (t, [d for d in data if fields(t[0]) | fields(t[1]) | fields(t[2]) <= set(d)])
        for t in templates
    ]
    compat = [(t, items) for t, items in compat if items]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_samples):
        template, items = compat[int(rng.integers(len(compat)))]
        item = items[int(rng.integers(len(items)))]
        rows.append(
            {
                "id": f"syn_{i}",
                "question": template[0].format(**item),
                "answers": [template[1].format(**item)],
                "context": template[2].format(**item),
                "metadata": {"source": "synthetic"},
            }
        )
    write_jsonl(output_path, rows)
    logger.info("Created %d synthetic examples", len(rows))
    return len(rows)


# ---------------------------------------------------------------------------
# Synthetic router training data
# ---------------------------------------------------------------------------


def synthetic_router_data(
    n_queries: int = 500,
    num_passages: int = 20,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded synthetic (bm25, dense, relevance) training tensors.

    Alternating regime (parity with the reference's --synthetic experiment,
    experiments/run_router_training.py:240-307): even queries are
    BM25-favoring (relevance correlates with BM25 scores), odd queries are
    dense-favoring — so a working router must learn per-query gating.
    """
    rng = np.random.default_rng(seed)
    bm25 = rng.normal(size=(n_queries, num_passages)).astype(np.float32)
    dense = rng.normal(size=(n_queries, num_passages)).astype(np.float32)
    rel = np.zeros((n_queries, num_passages), dtype=np.float32)
    for i in range(n_queries):
        signal = bm25[i] if i % 2 == 0 else dense[i]
        order = np.argsort(-signal)
        rel[i, order[:3]] = np.array([1.0, 0.7, 0.4], dtype=np.float32)
        rel[i] += rng.uniform(0, 0.05, size=num_passages).astype(np.float32)
    return bm25, dense, rel
