"""Router checkpoints: the loading half of ``rag_uq_tpu/router/train.py``
(``RouterTrainer.load_checkpoint``).

A checkpoint is ``<path>`` (flax msgpack of ``params``, ``stats`` and
``opt_state``) and ``<path>.json`` (the router config, the trained pool
width and the loss history). The port reads ``params`` and ``stats``;
``opt_state`` waits for the trainer (training slice).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict

from rag_uq_tpu_torch.convert import load_router
from rag_uq_tpu_torch.core.config import RouterConfig
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

logger = logging.getLogger(__name__)


def load_router_checkpoint(router: RetrievalRouter, path: str) -> Dict[str, Any]:
    """Load ``path`` into ``router`` in place, rebuilding it first when the
    stored architecture (``feature_set``, ``hidden_dim``, ...) differs.
    Returns the ``.json`` metadata ({} when there is none)."""
    meta: Dict[str, Any] = {}
    meta_path = Path(str(path) + ".json")
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    stored = meta.get("config")
    if stored:
        known = {f.name for f in dataclasses.fields(RouterConfig)}
        config = RouterConfig(**{k: v for k, v in stored.items() if k in known})
        if vars(config) != vars(router.config):
            logger.info("Checkpoint architecture differs; rebuilding the router")
            router._rebuild(config)
    tree = load_flax_checkpoint(str(path))
    load_router(router, tree["params"], tree["stats"])
    if meta:
        router.trained_num_passages = meta.get("trained_num_passages")
    logger.info("Loaded router checkpoint from %s", path)
    return meta
