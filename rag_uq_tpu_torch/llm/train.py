"""TinyLM checkpoints: the loading half of ``rag_uq_tpu/llm/train.py``.

``load_lm_checkpoint`` reads what the JAX trainer's ``save_checkpoint``
wrote: ``<path>.json`` for the model config and ``<path>`` (flax msgpack,
read by ``utils/checkpoint.py``) for the weights. The trainer waits for the
training slice.
"""

from __future__ import annotations

import json
import logging

from rag_uq_tpu_torch.convert import load_tiny_lm
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.llm.tiny_lm import TinyLM, TinyLMConfig
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

logger = logging.getLogger(__name__)


def load_lm_checkpoint(path: str, seed: int = 0, device: DeviceLike = "cuda") -> TinyLM:
    """Rebuild a sampling TinyLM from a saved trainer checkpoint."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    lm = TinyLM(TinyLMConfig(**meta["model_config"]), seed=seed, device=device)
    load_tiny_lm(lm, load_flax_checkpoint(str(path)))
    logger.info("Loaded TinyLM checkpoint from %s", path)
    return lm
