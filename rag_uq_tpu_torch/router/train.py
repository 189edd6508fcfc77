"""Router training: the counterpart of ``rag_uq_tpu/router/train.py``.

``RouterTrainer`` repeats the JAX trainer: AdamW (lr 1e-3, weight decay
1e-4) after a clip at global norm 1.0 (``utils/optim.py``, optax's terms),
ReduceLROnPlateau (factor 0.5, patience 3) on the validation loss written
into the injected learning rate, per-epoch shuffled minibatches from a
numpy generator seeded with ``TrainConfig.seed``, early stopping (patience
10) and ``best_router.msgpack`` at each new best validation loss. The loss
is ApproxNDCG on the soft fuse of the normalized towers plus, with
``decision_loss_weight``, a per-query BCE of the mean gate toward the
better arm by label reciprocal rank (ties carry no gradient). A step runs
the train-mode forward (EMA statistics updated first, dropout from a
``torch.Generator`` seeded with ``TrainConfig.seed``), autograd, the clip
and the update on the router's device.

A checkpoint is ``<path>`` (flax msgpack of ``params``, ``stats`` and
``opt_state``, the state of optax's ``inject_hyperparams(chain(clip,
adamw))``) and ``<path>.json`` (the router config, the train config, the
learning rate, the trained pool width and the loss histories), the files
the JAX trainer writes; either package loads the other's. As in the JAX
package, batch norm's running statistics are not saved.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.convert import load_router, router_to_flax
from rag_uq_tpu_torch.core.config import RouterConfig, TrainConfig
from rag_uq_tpu_torch.router.loss import approx_ndcg_loss
from rag_uq_tpu_torch.router.model import RetrievalRouter, normalize_towers
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint, save_flax_checkpoint
from rag_uq_tpu_torch.utils.optim import ClipAdamW

logger = logging.getLogger(__name__)

TrainData = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (bm25, dense, relevance)


def _stored_config(meta: Dict[str, Any]) -> Optional[RouterConfig]:
    stored = meta.get("config")
    if not stored:
        return None
    known = {f.name for f in dataclasses.fields(RouterConfig)}
    return RouterConfig(**{k: v for k, v in stored.items() if k in known})


def _read_meta(path: str) -> Dict[str, Any]:
    meta_path = Path(str(path) + ".json")
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


def load_router_checkpoint(router: RetrievalRouter, path: str) -> Dict[str, Any]:
    """Load ``path``'s ``params`` and ``stats`` into ``router`` in place,
    rebuilding it first when the stored architecture (``feature_set``,
    ``hidden_dim``, ...) differs. Returns the ``.json`` metadata ({} when
    there is none)."""
    meta = _read_meta(path)
    config = _stored_config(meta)
    if config is not None and vars(config) != vars(router.config):
        logger.info("Checkpoint architecture differs; rebuilding the router")
        router._rebuild(config)
    tree = load_flax_checkpoint(str(path))
    load_router(router, tree["params"], tree["stats"])
    if meta:
        router.trained_num_passages = meta.get("trained_num_passages")
    logger.info("Loaded router checkpoint from %s", path)
    return meta


def label_rr(scores: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Per-query reciprocal rank of the first relevant (>= 0.5) item under a
    tower's scores; rank(i) = 1 + #{j: s_j > s_i}."""
    ranks = 1.0 + (scores[..., None, :] > scores[..., :, None]).sum(dim=-1).float()
    return torch.where(rel >= 0.5, 1.0 / ranks, torch.zeros_like(ranks)).amax(dim=-1)


class RouterTrainer:
    """Training loop for the RetrievalRouter."""

    def __init__(
        self,
        router: RetrievalRouter,
        learning_rate: float = 1e-3,
        weight_decay: float = 1e-4,
        checkpoint_dir: str = "models/router",
        config: Optional[TrainConfig] = None,
    ):
        self.router = router
        self.config = config or TrainConfig(
            learning_rate=learning_rate,
            weight_decay=weight_decay,
            checkpoint_dir=checkpoint_dir,
        )
        self.checkpoint_dir = self.config.checkpoint_dir
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self._lr = self.config.learning_rate
        # optax holds the injected rate as a float32 array.
        self.optimizer = ClipAdamW(self.router.module.parameters(), float(np.float32(self._lr)),
                                   self.config.weight_decay, self.config.grad_clip_norm)
        self._plateau_best = float("inf")
        self._plateau_count = 0
        self._gen = torch.Generator(device=self.router.device).manual_seed(self.config.seed)

    def total_loss(self, weights: torch.Tensor, bm25: torch.Tensor, dense: torch.Tensor,
                   rel: torch.Tensor) -> torch.Tensor:
        """ApproxNDCG on the (normalized) soft fuse, plus the optional
        decision BCE. Training always fuses soft, whatever the deployment
        ``gate_policy``."""
        cfg = self.router.config
        b, d = normalize_towers(cfg, bm25, dense)
        loss = approx_ndcg_loss(weights * d + (1 - weights) * b, rel, None, cfg.temperature)
        decision_w = float(cfg.decision_loss_weight)
        if decision_w > 0.0:
            rr_b, rr_d = label_rr(b, rel), label_rr(d, rel)
            target = (rr_d > rr_b).float()
            decisive = ((rr_d - rr_b).abs() > 1e-9).float()
            wq = weights.mean(dim=-1).clamp(1e-6, 1.0 - 1e-6)
            bce = -(target * torch.log(wq) + (1.0 - target) * torch.log(1.0 - wq))
            loss = loss + decision_w * (bce * decisive).sum() / decisive.sum().clamp(min=1.0)
        return loss

    def _tensors(self, data: TrainData):
        return [torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.router.device)
                for a in data]

    # -- steps -------------------------------------------------------------------

    def train_epoch(self, train_data: TrainData) -> float:
        """One optimizer step on the given (mini)batch."""
        bm25, dense, rel = self._tensors(train_data)
        weights = self.router.module(bm25, dense, update_stats=True, train=True,
                                     dropout_gen=self._gen)
        loss = self.total_loss(weights, bm25, dense, rel)
        loss.backward()
        self.optimizer.step()
        return loss.item()

    @torch.no_grad()
    def validate(self, val_data: TrainData) -> float:
        bm25, dense, rel = self._tensors(val_data)
        return float(self.total_loss(self.router.module(bm25, dense), bm25, dense, rel))

    def _plateau_step(self, val_loss: float) -> None:
        """ReduceLROnPlateau(factor, patience) on the injected lr."""
        if val_loss < self._plateau_best:
            self._plateau_best = val_loss
            self._plateau_count = 0
            return
        self._plateau_count += 1
        if self._plateau_count > self.config.plateau_patience:
            self._lr *= self.config.plateau_factor
            self.optimizer.lr = float(np.float32(self._lr))
            self._plateau_count = 0
            logger.info("Reduced learning rate to %g", self._lr)

    # -- fit ----------------------------------------------------------------------

    def fit(
        self,
        train_data: TrainData,
        val_data: Optional[TrainData] = None,
        num_epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        early_stopping_patience: Optional[int] = None,
    ) -> Dict[str, list]:
        """Shuffled-minibatch training with early stopping."""
        num_epochs = num_epochs or self.config.num_epochs
        batch_size = batch_size or self.config.batch_size
        patience = early_stopping_patience or self.config.early_stopping_patience

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        bm25_train, dense_train, rel_train = (np.asarray(a, dtype=np.float32) for a in train_data)
        self.router.trained_num_passages = int(bm25_train.shape[1])
        num_samples = bm25_train.shape[0]
        shuffle_rng = np.random.default_rng(self.config.seed)

        best_val_loss = float("inf")
        patience_counter = 0
        for epoch in range(num_epochs):
            perm = shuffle_rng.permutation(num_samples)
            epoch_losses = []
            for i in range(0, num_samples, batch_size):
                sel = perm[i : i + batch_size]
                epoch_losses.append(
                    self.train_epoch((bm25_train[sel], dense_train[sel], rel_train[sel])))
            avg_train = float(np.mean(epoch_losses))
            self.train_losses.append(avg_train)

            if val_data is None:
                logger.info("Epoch %d/%d - Train Loss: %.4f", epoch + 1, num_epochs, avg_train)
                continue
            val_loss = self.validate(val_data)
            self.val_losses.append(val_loss)
            self._plateau_step(val_loss)
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                patience_counter = 0
                self.save_checkpoint(os.path.join(self.checkpoint_dir, "best_router.msgpack"))
            else:
                patience_counter += 1
            logger.info("Epoch %d/%d - Train Loss: %.4f, Val Loss: %.4f",
                        epoch + 1, num_epochs, avg_train, val_loss)
            if patience_counter >= patience:
                logger.info("Early stopping at epoch %d", epoch + 1)
                break
        return {"train_losses": self.train_losses, "val_losses": self.val_losses}

    # -- checkpointing -------------------------------------------------------------

    def opt_state_tree(self) -> Dict[str, Any]:
        """optax's ``InjectHyperparamsState`` of ``chain(clip, adamw(lr))``."""
        adam = self.optimizer.adam_state(self.router.module.flax_params())
        return {
            "count": np.asarray(self.optimizer.count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(self.optimizer.lr, np.float32)},
            "hyperparams_states": {},
            "inner_state": {"0": {}, "1": {"0": adam, "1": {}, "2": {}}},
        }

    def save_checkpoint(self, path: str) -> None:
        """Params + EMA stats + optimizer state + config + loss history."""
        params, stats = router_to_flax(self.router)
        save_flax_checkpoint(path, {"params": params, "stats": stats,
                                    "opt_state": self.opt_state_tree()})
        meta = {
            "config": vars(self.router.config),
            "train_config": vars(self.config),
            "lr": self._lr,
            "trained_num_passages": self.router.trained_num_passages,
            "train_losses": self.train_losses,
            "val_losses": self.val_losses,
        }
        with open(str(path) + ".json", "w") as f:
            json.dump(meta, f, indent=2)
        logger.info("Saved checkpoint to %s", path)

    def load_checkpoint(self, path: str) -> None:
        """Params, stats and optimizer state from ``path``, rebuilding the
        router (and this trainer around it) when the stored architecture
        differs."""
        meta = _read_meta(path)
        config = _stored_config(meta)
        if config is not None and vars(config) != vars(self.router.config):
            logger.info("Checkpoint architecture differs; rebuilding router")
            self.router._rebuild(config)
            self.__init__(self.router, config=self.config)
        tree = load_flax_checkpoint(str(path))
        load_router(self.router, tree["params"], tree["stats"])
        opt = tree["opt_state"]
        self.optimizer.load_adam_state(self.router.module.flax_params(),
                                       opt["inner_state"]["1"]["0"])
        self.optimizer.count = int(np.asarray(opt["count"]))
        self.optimizer.lr = float(np.asarray(opt["hyperparams"]["learning_rate"]))
        if meta:
            self.train_losses = meta.get("train_losses", [])
            self.val_losses = meta.get("val_losses", [])
            self._lr = meta.get("lr", self._lr)
            self.router.trained_num_passages = meta.get("trained_num_passages")
        logger.info("Loaded checkpoint from %s", path)
