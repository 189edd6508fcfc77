"""Model zoo: the port's three network modules in one namespace, as
``rag_uq_tpu/models/__init__.py`` has the JAX package's.

- RouterModule: the retrieval-gating MLP (rag_uq_tpu_torch.router.model)
- EncoderModel: the transformer text encoder (rag_uq_tpu_torch.embed.encoder)
- DecoderModel: the byte-level generation decoder (rag_uq_tpu_torch.llm.tiny_lm)

Each ships with its stateful convenience wrapper (RetrievalRouter,
TransformerEmbedder, TinyLM) in its home module.
"""

from rag_uq_tpu_torch.embed.encoder import EncoderConfig, EncoderModel
from rag_uq_tpu_torch.llm.tiny_lm import DecoderModel, TinyLMConfig
from rag_uq_tpu_torch.router.model import RouterModule

__all__ = [
    "RouterModule",
    "EncoderModel",
    "EncoderConfig",
    "DecoderModel",
    "TinyLMConfig",
]
