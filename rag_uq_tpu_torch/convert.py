"""Carry parameters and state between the JAX package and the port.

The loaders take numpy arrays (the caller turns JAX arrays, and bf16
values, into numpy f32 first), and the ``*_to_flax`` functions give the
port's modules back as flax trees of numpy float32 arrays, so the port
needs neither flax nor msgpack.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.flax_nn import flax_tree, load_flax_tree
from rag_uq_tpu_torch.router.model import STAT_NAMES, RetrievalRouter


def load_router(
    router: RetrievalRouter, params: Mapping[str, Any], stats: Mapping[str, Any]
) -> RetrievalRouter:
    """Copy a flax ``RouterModule``'s ``params`` and ``stats`` into ``router``.

    flax names its layers ``Dense_0 .. Dense_{n-1}`` (the last is the output
    layer) and ``BatchNorm_i``, and stores kernels ``[in, out]``;
    ``nn.Linear`` stores ``[out, in]``, so kernels are transposed.
    """
    leaves = router.module.flax_params()
    names = {path[0] for path, *_ in leaves}
    if set(params) != names:
        raise ValueError(f"flax layers {sorted(params)} != the router's {sorted(names)}")
    load_flax_tree(leaves, params)
    with torch.no_grad():
        for name in STAT_NAMES:
            getattr(router.module, name).fill_(float(np.asarray(stats[name])))
    return router


def router_to_flax(router: RetrievalRouter) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """The inverse of ``load_router``: (``params``, ``stats``) as flax trees
    of float32 numpy arrays."""
    module = router.module
    stats = {name: np.asarray(float(getattr(module, name)), np.float32) for name in STAT_NAMES}
    return flax_tree(module.flax_params()), stats


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


def encoder_to_flax(embedder) -> Dict[str, Any]:
    """The inverse of ``load_encoder``: ``{"params": ...}`` of float32 numpy
    arrays, as the JAX ``TransformerEmbedder.params``."""
    return {"params": flax_tree(embedder.model.flax_params())}


def tiny_lm_to_flax(lm) -> Dict[str, Any]:
    """The inverse of ``load_tiny_lm``: the flax ``DecoderModel`` tree of
    float32 numpy arrays."""
    return flax_tree(lm.model.flax_params())
