"""Model zoo: the port's three network modules in one namespace, as
``rag_uq_tpu/models/__init__.py`` has the JAX package's.

- RouterModule: the retrieval-gating MLP (rag_uq_tpu_torch.router.model)
- EncoderModel: the transformer text encoder (rag_uq_tpu_torch.embed.encoder)
- DecoderModel: the byte-level generation decoder (rag_uq_tpu_torch.llm.tiny_lm)
- DeepseekV2Model: DeepSeek-V2's latent-attention, expert-layer decoder
  (rag_uq_tpu_torch.llm.deepseek_v2; the port's own, with no JAX counterpart)
- KimiLinearModel: Kimi Linear's decoder of Kimi Delta Attention and
  latent-attention layers with sigmoid-routed experts
  (rag_uq_tpu_torch.llm.kimi_linear; the port's own, with no JAX counterpart)

Each ships with its stateful convenience wrapper (RetrievalRouter,
TransformerEmbedder, TinyLM, DeepseekV2LM, KimiLinearLM) in its home module.
"""

from rag_uq_tpu_torch.embed.encoder import EncoderConfig, EncoderModel
from rag_uq_tpu_torch.llm.deepseek_v2 import DeepseekV2Config, DeepseekV2Model
from rag_uq_tpu_torch.llm.kimi_linear import KimiLinearConfig, KimiLinearModel
from rag_uq_tpu_torch.llm.tiny_lm import DecoderModel, TinyLMConfig
from rag_uq_tpu_torch.router.model import RouterModule

__all__ = [
    "RouterModule",
    "EncoderModel",
    "EncoderConfig",
    "DecoderModel",
    "TinyLMConfig",
    "DeepseekV2Model",
    "DeepseekV2Config",
    "KimiLinearModel",
    "KimiLinearConfig",
]
