"""Embedder interface and factory: the counterpart of ``rag_uq_tpu/embed/base.py``."""

from __future__ import annotations

from typing import Callable, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import EmbedderConfig
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.core.mesh import gather_shards, mesh_rank


def encode_on_mesh(
    device_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    featurize: Callable[[Sequence[str]], Tuple[np.ndarray, np.ndarray]],
    texts: Sequence[str],
    mesh,
) -> np.ndarray:
    """Encode a batch data-parallel over the mesh: every rank gets all of it.

    The batch is cut into one slice a rank, padded to equal slices (ids 0,
    length 1, as the JAX package pads); each rank hashes its own slice with
    ``featurize`` (texts -> ids [n, L], lengths [n]) and runs ``device_fn``
    (ids, lengths -> [n, D]) on it, and an all-gather gives every rank the
    whole ``[B, D]``, returned trimmed to B as a float32 host array.

    The JAX function (``embed/base.py::encode_on_mesh``) takes ids hashed
    for the whole batch, because one process holds it; here every rank holds
    every text, so each hashes only its slice and the host hashing, the
    larger share of ingest, is split too.
    """
    n_ranks = mesh.size()
    n = len(texts)
    per = -(-n // n_ranks)
    r = mesh_rank(mesh)
    ids, lengths = featurize(list(texts[r * per : (r + 1) * per]))
    pad = per - ids.shape[0]
    if pad:
        ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), dtype=ids.dtype)])
        lengths = np.concatenate([lengths, np.ones((pad,), dtype=lengths.dtype)])
    local = device_fn(torch.from_numpy(ids), torch.from_numpy(lengths)).float()
    if n == 0:
        return local.cpu().numpy()
    out = gather_shards(local, mesh).reshape(n_ranks * per, -1)
    return out[:n].cpu().numpy()


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
