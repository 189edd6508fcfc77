"""Deterministic hash embedders: the counterpart of ``rag_uq_tpu/embed/hash_embed.py``."""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.text.tokenize import hash_texts
from rag_uq_tpu_torch.utils import profiling


class Sha256Embedder:
    """SHA-256 pseudo-embedding, extended to `dim` via counter blocks.

    A copy of the JAX package's test double (host-only, numpy)."""

    def __init__(self, dim: int = 768):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        n_blocks = (self.dim + 31) // 32
        for i, text in enumerate(texts):
            buf = bytearray()
            for blk in range(n_blocks):
                buf += hashlib.sha256(f"{text}\x00{blk}".encode()).digest()
            vec = np.frombuffer(bytes(buf[: self.dim]), dtype=np.uint8)
            out[i] = vec.astype(np.float32) / 255.0
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


def bag_embed(
    table: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Masked mean of table rows, L2-normalized. ids: [B, L], lengths: [B].

    The arithmetic of ``hash_embed.py::_bag_embed`` as XLA runs it: the sum
    is taken in f32 and rounded to the table dtype (``jnp.sum`` of bf16),
    while the quotient by the length keeps f32 precision (XLA drops the
    bf16 round trip of the mean); the norm is taken in f32.
    """
    vecs = table[ids.long()]  # [B, L, D]
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
    summed = (vecs * mask[:, :, None].to(vecs.dtype)).float().sum(dim=1)
    mean = summed.to(vecs.dtype).float() / lengths.float().clamp(min=1.0)[:, None]
    norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    return mean / norm.clamp(min=1e-12)


class NgramHashEmbedder:
    """Hashed unigram+bigram bag through a fixed random table, on the device.

    Each token (and adjacent bigram) hashes into one of `buckets` rows of a
    fixed N(0, 1/sqrt(dim)) bf16 table; a text embeds as the L2-normalized
    masked mean of its feature rows.

    ``jax.random.normal(PRNGKey(seed))`` cannot be regenerated in PyTorch,
    so ``table`` takes the JAX embedder's table (see ``convert.py``).
    Without one, the table is drawn from a ``torch.Generator`` seeded with
    ``seed``: same distribution and dtype, different values from the JAX
    table.
    """

    def __init__(
        self,
        dim: int = 768,
        buckets: int = 1 << 15,
        seed: int = 0,
        max_len: int = 256,
        use_bigrams: bool = True,
        table: Optional[torch.Tensor] = None,
        device: DeviceLike = "cuda",
    ):
        self.dim = dim
        self.buckets = buckets
        self.max_len = max_len
        self.use_bigrams = use_bigrams
        self.device = resolve_device(device)
        if table is None:
            gen = torch.Generator().manual_seed(seed)
            table = torch.randn((buckets, dim), generator=gen) / math.sqrt(dim)
        if tuple(table.shape) != (buckets, dim):
            raise ValueError(f"table shape {tuple(table.shape)} != {(buckets, dim)}")
        self.table = table.to(device=self.device, dtype=torch.bfloat16)

    def _hash_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Feature ids [B, max_len] int32, zero-padded, and lengths [B] int32
        (``text/tokenize.py::hash_texts`` with this embedder's bigrams)."""
        with profiling.span("embed.hash"):
            return hash_texts(texts, self.buckets, self.max_len, self.use_bigrams)

    def encode_device(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Embeddings [B, dim] f32 on the device for pre-hashed features."""
        with profiling.span("embed.bag", cuda=self.table.is_cuda):
            return bag_embed(self.table, ids.to(self.device), lengths.to(self.device))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        ids, lengths = self._hash_batch(texts)
        out = self.encode_device(torch.from_numpy(ids), torch.from_numpy(lengths))
        with profiling.span("embed.readback"):
            return out.cpu().numpy()

    def encode_mesh(self, texts: Sequence[str], mesh) -> np.ndarray:
        """Batch embedding data-parallel over the mesh (``encode_on_mesh``)."""
        from rag_uq_tpu_torch.embed.base import encode_on_mesh

        return encode_on_mesh(self.encode_device, self._hash_batch, texts, mesh)
