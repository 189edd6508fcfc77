"""Dataset verification: a copy of ``rag_uq_tpu/data/verify.py``.

Capability parity with the reference's verifier
(data/preprocessing/verify_dataset.py): SHA-256 file hash (:22-28), JSONL
validation with record counts, field coverage histogram, text-length
statistics, duplicate-id detection and sample records (:31-120), NQ-specific
question/answer statistics (:123-170), and a human-readable report (:173-229).
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


def file_sha256(path: str, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_size)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def verify_jsonl_dataset(
    path: str, id_field: str = "id", text_field: str = "text", n_samples: int = 3
) -> Dict[str, Any]:
    """Validate a JSONL dataset: counts, fields, lengths, duplicates."""
    total = 0
    invalid = 0
    field_counts: Counter = Counter()
    text_lengths: List[int] = []
    ids: Counter = Counter()
    samples: List[Dict] = []

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            total += 1
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                invalid += 1
                continue
            for key in row:
                field_counts[key] += 1
            if text_field in row:
                text_lengths.append(len(str(row[text_field])))
            if id_field in row:
                ids[str(row[id_field])] += 1
            if len(samples) < n_samples:
                samples.append(row)

    duplicates = {k: v for k, v in ids.items() if v > 1}
    lengths = np.asarray(text_lengths) if text_lengths else np.asarray([0])
    return {
        "path": str(path),
        "sha256": file_sha256(path),
        "total_lines": total,
        "valid_records": total - invalid,
        "invalid_records": invalid,
        "field_coverage": dict(field_counts),
        "text_length": {
            "mean": float(lengths.mean()),
            "min": int(lengths.min()),
            "max": int(lengths.max()),
            "p50": float(np.percentile(lengths, 50)),
        },
        "unique_ids": len(ids),
        "duplicate_ids": len(duplicates),
        "duplicate_examples": list(duplicates)[:5],
        "samples": samples,
    }


def verify_nq_dataset(path: str) -> Dict[str, Any]:
    """NQ-specific statistics: question/answer counts and lengths."""
    base = verify_jsonl_dataset(path, text_field="question")
    q_lengths: List[int] = []
    a_counts: List[int] = []
    with_context = 0
    for row in _iter_valid(path):
        q = row.get("question", "")
        q_lengths.append(len(str(q).split()))
        answers = row.get("answers", [])
        a_counts.append(len(answers) if isinstance(answers, list) else 1)
        if row.get("context"):
            with_context += 1
    q = np.asarray(q_lengths) if q_lengths else np.asarray([0])
    a = np.asarray(a_counts) if a_counts else np.asarray([0])
    base["nq"] = {
        "avg_question_words": float(q.mean()),
        "avg_answers_per_question": float(a.mean()),
        "records_with_context": with_context,
    }
    return base


def _iter_valid(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def generate_report(results: Dict[str, Any], output_path: Optional[str] = None) -> str:
    """Human-readable verification report."""
    lines = [
        "=" * 60,
        "DATASET VERIFICATION REPORT",
        "=" * 60,
        f"File: {results['path']}",
        f"SHA-256: {results['sha256']}",
        f"Total lines: {results['total_lines']}",
        f"Valid records: {results['valid_records']}",
        f"Invalid records: {results['invalid_records']}",
        f"Unique ids: {results['unique_ids']}"
        f" (duplicates: {results['duplicate_ids']})",
        "Field coverage:",
    ]
    for field, count in sorted(results["field_coverage"].items()):
        lines.append(f"  {field}: {count}")
    tl = results["text_length"]
    lines.append(
        f"Text length: mean={tl['mean']:.0f} p50={tl['p50']:.0f} "
        f"min={tl['min']} max={tl['max']}"
    )
    if "nq" in results:
        nq = results["nq"]
        lines += [
            "NQ statistics:",
            f"  avg question words: {nq['avg_question_words']:.1f}",
            f"  avg answers/question: {nq['avg_answers_per_question']:.1f}",
            f"  records with context: {nq['records_with_context']}",
        ]
    lines.append("=" * 60)
    report = "\n".join(lines)
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            f.write(report)
    return report
