"""Streaming, checkpointed corpus ingest: the counterpart of ``rag_uq_tpu/index/build.py``.

Resumable JSONL ingest with a line-offset JSON checkpoint ({last_offset,
total_indexed, files_completed, file_sig}) saved after every batch, a
size+mtime signature that restarts the offset when the file changed,
malformed lines skipped with a warning, and a generator of per-batch counts.
The checkpoint format is the JAX package's, so either package resumes what
the other started.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Iterator

from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

logger = logging.getLogger(__name__)


class StreamingIndex:
    """Streaming document indexer with checkpoint/resume."""

    def __init__(
        self,
        retriever: HybridRetriever,
        checkpoint_path: str = "./data/index_checkpoint.json",
        batch_size: int = 100,
    ):
        self.retriever = retriever
        self.checkpoint_path = Path(checkpoint_path)
        self.batch_size = batch_size
        self.progress = self._load_checkpoint()

    def _load_checkpoint(self) -> Dict[str, Any]:
        if self.checkpoint_path.exists():
            with open(self.checkpoint_path) as f:
                return json.load(f)
        return {"last_offset": 0, "total_indexed": 0, "files_completed": []}

    def _save_checkpoint(self) -> None:
        self.checkpoint_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.checkpoint_path, "w") as f:
            json.dump(self.progress, f)

    @staticmethod
    def _file_sig(path: Path) -> str:
        stat = path.stat()
        return f"{stat.st_size}:{int(stat.st_mtime)}"

    def stream_from_jsonl(self, jsonl_path: str, resume: bool = True) -> Iterator[int]:
        """Index documents from JSONL, yielding per-batch counts."""
        path = Path(jsonl_path)
        if not path.exists():
            raise FileNotFoundError(f"Corpus file not found: {jsonl_path}")

        # Resume applies only to the same file contents: a size+mtime
        # signature invalidates the offset when the file changed.
        sig = self._file_sig(path)
        if self.progress.get("file_sig") not in (None, sig):
            logger.info(
                "Corpus file changed since checkpoint (sig %s -> %s); "
                "restarting from offset 0",
                self.progress.get("file_sig"), sig,
            )
            self.progress["last_offset"] = 0
            self.progress["files_completed"] = [
                f for f in self.progress["files_completed"] if f != jsonl_path
            ]
        self.progress["file_sig"] = sig

        start_offset = self.progress["last_offset"] if resume else 0
        with open(path) as f:
            for _ in range(start_offset):
                f.readline()

            batch = []
            offset = start_offset
            for line in f:
                try:
                    data = json.loads(line.strip())
                    batch.append(
                        Document(
                            id=data["id"],
                            text=data["text"],
                            title=data.get("title"),
                            metadata=data.get("metadata"),
                        )
                    )
                except (json.JSONDecodeError, KeyError) as e:
                    logger.warning("Skipping invalid line at offset %d: %s", offset, e)
                offset += 1

                if len(batch) >= self.batch_size:
                    self.retriever.add_documents(batch)
                    self.progress["last_offset"] = offset
                    self.progress["total_indexed"] += len(batch)
                    self._save_checkpoint()
                    logger.info(
                        "Indexed batch: %d docs, total: %d",
                        len(batch), self.progress["total_indexed"],
                    )
                    yield len(batch)
                    batch = []

            if batch:
                self.retriever.add_documents(batch)
                self.progress["last_offset"] = offset
                self.progress["total_indexed"] += len(batch)
                self._save_checkpoint()
                yield len(batch)

        if jsonl_path not in self.progress["files_completed"]:
            self.progress["files_completed"].append(jsonl_path)
            self._save_checkpoint()
        logger.info("Completed indexing %s", jsonl_path)

    def get_progress(self) -> Dict[str, Any]:
        return {**self.progress, "retriever_size": len(self.retriever)}
