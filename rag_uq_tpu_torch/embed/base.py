"""Embedder interface and factory: the counterpart of ``rag_uq_tpu/embed/base.py``."""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from rag_uq_tpu_torch.core.config import EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike


@runtime_checkable
class Embedder(Protocol):
    """Batched text -> L2-normalized vectors."""

    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Return [len(texts), dim] float32 L2-normalized embeddings."""
        ...


def get_embedder(config: EmbedderConfig, device: DeviceLike = "cuda") -> Embedder:
    from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder, Sha256Embedder

    if config.kind == "sha256":
        return Sha256Embedder(dim=config.dim)
    if config.kind == "ngram_hash":
        return NgramHashEmbedder(
            dim=config.dim,
            buckets=config.vocab_hash_buckets,
            seed=config.seed,
            max_len=config.max_seq_len,
            device=device,
        )
    if config.kind == "encoder":
        from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder

        if config.checkpoint_path:
            from rag_uq_tpu_torch.embed.train import load_encoder_checkpoint

            return load_encoder_checkpoint(config.checkpoint_path, device=device)
        # A seeded torch init: JAX's PRNGKey stream cannot be reproduced in
        # torch, so the weights differ from the JAX embedder's for one seed.
        return TransformerEmbedder(
            EncoderConfig(
                dim=config.dim,
                num_layers=config.encoder_layers,
                num_heads=config.encoder_heads,
                mlp_dim=config.encoder_mlp_dim,
                max_seq_len=config.max_seq_len,
                vocab_buckets=config.vocab_hash_buckets,
            ),
            seed=config.seed,
            device=device,
        )
    raise ValueError(f"Unknown embedder kind: {config.kind!r}")
