"""Transformer text encoder: the counterpart of ``rag_uq_tpu/embed/encoder.py``.

A pre-LayerNorm transformer over hashed token ids (``text/tokenize.py::
hash_texts``, so no tokenizer asset), a masked mean pool and an L2
normalization, with flax's numerics at ``dtype`` (``core/flax_nn.py``).
Weights come from a trained checkpoint (``embed/train.py::
load_encoder_checkpoint``) or a seeded torch init, whose values differ from
a JAX init with the same seed.

The attention mask is ``valid[q] & valid[k]``, as flax's
``make_attention_mask(valid, valid)``: padded query rows see every key
masked, and their softmax over equal most-negative logits stays finite; the
pool never reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.flax_nn import (
    Dense, Embed, FlaxLeaf, LayerNorm, MultiHeadAttention, flax_leaves, gelu, load_flax_tree,
    torch_dtype,
)
from rag_uq_tpu_torch.text.tokenize import hash_texts


@dataclass(frozen=True)
class EncoderConfig:
    dim: int = 768
    num_layers: int = 4
    num_heads: int = 12
    mlp_dim: int = 1536
    max_seq_len: int = 128
    vocab_buckets: int = 1 << 15
    dtype: str = "bfloat16"


class TransformerBlock(nn.Module):
    def __init__(self, config: EncoderConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.ln_attn = LayerNorm(config.dim, dt)
        self.attn = MultiHeadAttention(config.dim, config.num_heads, dt, gen)
        self.ln_mlp = LayerNorm(config.dim, dt)
        self.mlp_in = Dense(config.dim, config.mlp_dim, dt, gen)
        self.mlp_out = Dense(config.mlp_dim, config.dim, dt, gen)

    def flax_params(self) -> List[FlaxLeaf]:
        return (flax_leaves(self.ln_attn, ("LayerNorm_0",))
                + flax_leaves(self.attn, ("MultiHeadDotProductAttention_0",))
                + flax_leaves(self.ln_mlp, ("LayerNorm_1",))
                + flax_leaves(self.mlp_in, ("Dense_0",))
                + flax_leaves(self.mlp_out, ("Dense_1",)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), mask)
        return x + self.mlp_out(gelu(self.mlp_in(self.ln_mlp(x))))


class EncoderModel(nn.Module):
    """ids [B, L] int, lengths [B] -> L2-normalized [B, dim] float32."""

    def __init__(self, config: EncoderConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dt = torch_dtype(config.dtype)
        self.tok = Embed(config.vocab_buckets, config.dim, dt, gen)
        self.pos = Embed(config.max_seq_len, config.dim, dt, gen)
        self.blocks = nn.ModuleList(TransformerBlock(config, gen) for _ in range(config.num_layers))
        self.ln_out = LayerNorm(config.dim, dt)

    def flax_params(self) -> List[FlaxLeaf]:
        """The leaves of flax's ``params`` tree; blocks by their number."""
        leaves = flax_leaves(self.tok, ("Embed_0",)) + flax_leaves(self.pos, ("Embed_1",))
        for i, block in enumerate(self.blocks):
            leaves += flax_leaves(block, (f"TransformerBlock_{i}",))
        return leaves + flax_leaves(self.ln_out, ("LayerNorm_0",))

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(ids.shape[1], device=ids.device)
        valid = positions[None, :] < lengths[:, None]  # [B, L]
        x = self.tok(ids) + self.pos(positions)[None]
        mask = (valid[:, None, :, None] & valid[:, None, None, :])  # [B, 1, L, L]
        for block in self.blocks:
            x = block(x, mask)
        x = self.ln_out(x)
        m = valid.float()[:, :, None]
        pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / norm.clamp(min=1e-12)


class TransformerEmbedder:
    """Batched encoder embedder on ``device``."""

    def __init__(self, config: Optional[EncoderConfig] = None, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.config = config or EncoderConfig()
        self.dim = self.config.dim
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.model = EncoderModel(self.config, gen).to(self.device).eval()

    def load_params(self, params) -> None:
        """Load a flax parameter tree (``{"params": ...}`` or its inside)."""
        load_flax_tree(self.model.flax_params(), params.get("params", params))

    @torch.no_grad()
    def encode_device(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Embeddings [B, dim] f32 on the device for hashed ids [B, L]."""
        return self.model(ids.to(self.device), lengths.to(self.device))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        ids, lengths = hash_texts(texts, self.config.vocab_buckets, self.config.max_seq_len)
        out = self.encode_device(torch.from_numpy(ids), torch.from_numpy(lengths))
        return out.cpu().numpy()

    def encode_mesh(self, texts: Sequence[str], mesh) -> np.ndarray:
        """Batch embedding data-parallel over the mesh (``encode_on_mesh``):
        the forward runs on every rank's slice of the batch."""
        from rag_uq_tpu_torch.embed.base import encode_on_mesh

        cfg = self.config
        return encode_on_mesh(
            self.encode_device, lambda ts: hash_texts(ts, cfg.vocab_buckets, cfg.max_seq_len),
            texts, mesh)
