"""Carry parameters and state from the JAX package to the port.

Every function takes numpy arrays (the caller turns JAX arrays, and bf16
values, into numpy f32 first), so the port needs neither flax nor msgpack.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.router.model import STAT_NAMES, RetrievalRouter


def load_router(
    router: RetrievalRouter, params: Mapping[str, Any], stats: Mapping[str, Any]
) -> RetrievalRouter:
    """Copy a flax ``RouterModule``'s ``params`` and ``stats`` into ``router``.

    flax names its layers ``Dense_0 .. Dense_{n-1}`` (the last is the output
    layer) and stores kernels ``[in, out]``; ``nn.Linear`` stores
    ``[out, in]``, so kernels are transposed.
    """
    module = router.module
    layers = [*module.hidden, module.out]
    if len(params) != len(layers):
        raise ValueError(f"{len(params)} flax layers for {len(layers)} torch layers")
    with torch.no_grad():
        for i, layer in enumerate(layers):
            dense = params[f"Dense_{i}"]
            kernel = np.asarray(dense["kernel"], dtype=np.float32)
            if kernel.T.shape != tuple(layer.weight.shape):
                raise ValueError(f"Dense_{i} kernel {kernel.shape} != {tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.tensor(kernel.T))
            layer.bias.copy_(torch.tensor(np.asarray(dense["bias"], dtype=np.float32)))
        for name in STAT_NAMES:
            getattr(module, name).fill_(float(np.asarray(stats[name])))
    return router


def embedding_table(table: np.ndarray) -> torch.Tensor:
    """The ``NgramHashEmbedder`` table (f32 values of the bf16 table) as a
    tensor for ``rag_uq_tpu_torch.embed.hash_embed.NgramHashEmbedder(table=)``."""
    return torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32)).to(
        torch.bfloat16
    )


def bm25_device_state(
    arrays: Mapping[str, Any], impact_dtype: torch.dtype, device: DeviceLike = "cuda"
) -> Dict[str, Any]:
    """A synced BM25 device layout (``BM25Index._device``) as torch tensors.

    ``arrays`` holds numpy arrays (the impact matrix as f32 values) and the
    python scalars ``beam``, ``nonneg``, ``max_df`` and ``n_docs_cap``.
    """
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, value in arrays.items():
        if isinstance(value, np.ndarray):
            t = torch.from_numpy(np.array(value))
            if name == "impact":
                t = t.to(impact_dtype)
            out[name] = t.to(dev)
        else:
            out[name] = value
    return out


def load_encoder(embedder, params: Mapping[str, Any]):
    """Copy a flax ``EncoderModel`` tree (``{"params": ...}`` or its inside)
    into a ``TransformerEmbedder``; returns it."""
    embedder.load_params(params)
    return embedder


def load_tiny_lm(lm, params: Mapping[str, Any]):
    """Copy a flax ``DecoderModel`` parameter tree into a ``TinyLM``; returns it."""
    lm.load_params(params)
    return lm
