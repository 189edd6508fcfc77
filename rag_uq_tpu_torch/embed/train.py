"""Encoder checkpoints: the loading half of ``rag_uq_tpu/embed/train.py``.

``load_encoder_checkpoint`` reads what the JAX ``EncoderTrainer.save_checkpoint``
wrote: ``<path>.json`` for the encoder config and ``<path>`` (flax msgpack,
read by ``utils/checkpoint.py``) for the weights. The trainer itself waits
for the training slice.
"""

from __future__ import annotations

import json
import logging

from rag_uq_tpu_torch.convert import load_encoder
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

logger = logging.getLogger(__name__)


def load_encoder_checkpoint(path: str, device: DeviceLike = "cuda") -> TransformerEmbedder:
    """Rebuild a TransformerEmbedder from a saved checkpoint."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    embedder = TransformerEmbedder(EncoderConfig(**meta["encoder_config"]), device=device)
    load_encoder(embedder, load_flax_checkpoint(str(path)))
    logger.info("Loaded encoder checkpoint from %s", path)
    return embedder
