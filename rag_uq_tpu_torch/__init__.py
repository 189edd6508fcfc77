"""PyTorch and CUDA port of ``rag_uq_tpu``, for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths and public names
(``rag_uq_tpu/__init__.py``). Importing it builds and launches nothing: kernels and
the native tokenizer are built at first use. Entry points take ``device``
("cuda" by default) and raise when no card is present and the caller did
not ask for the CPU.
"""

from rag_uq_tpu_torch.core.types import Document, RetrievalResult
from rag_uq_tpu_torch.core.config import (
    RouterConfig,
    BM25Config,
    DenseIndexConfig,
    UQConfig,
    EvalConfig,
)
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.loss import ApproxNDCGLoss, approx_ndcg_loss
from rag_uq_tpu_torch.router.train import RouterTrainer
from rag_uq_tpu_torch.router.labels import create_pseudo_labels
from rag_uq_tpu_torch.index.dense import DenseIndex
from rag_uq_tpu_torch.index.sparse import BM25Index
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.index.build import StreamingIndex
from rag_uq_tpu_torch.parallel.sharded_index import ShardedHybridIndex
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.uq.conformal import ConformalRAG
from rag_uq_tpu_torch.uq.hybrid import HybridConfidence
from rag_uq_tpu_torch.eval.evaluator import RAGEvaluator
from rag_uq_tpu_torch.data.chunk import chunk_text
from rag_uq_tpu_torch.llm.mock import MockLLM
from rag_uq_tpu_torch.llm.tiny_lm import TinyLM
from rag_uq_tpu_torch.cli.serve import QueryService

__version__ = "0.1.0"

__all__ = [
    "Document",
    "RetrievalResult",
    "RouterConfig",
    "BM25Config",
    "DenseIndexConfig",
    "UQConfig",
    "EvalConfig",
    "RetrievalRouter",
    "ApproxNDCGLoss",
    "approx_ndcg_loss",
    "RouterTrainer",
    "create_pseudo_labels",
    "DenseIndex",
    "BM25Index",
    "HybridRetriever",
    "StreamingIndex",
    "ShardedHybridIndex",
    "MCDropoutConfidence",
    "ConformalRAG",
    "HybridConfidence",
    "RAGEvaluator",
    "chunk_text",
    "MockLLM",
    "TinyLM",
    "QueryService",
]
