"""Learned retrieval router: the counterpart of ``rag_uq_tpu/router/model.py``.

``RouterModule`` computes the per-passage gate: features from the EMA score
statistics (or the batch's, until they are initialized), the ``pool7``
pool-context features when configured, an MLP of ``num_layers - 1`` hidden
blocks (``Linear``, optional ``BatchNorm``, ReLU, ``Dropout``), a final
``Linear(1)`` and a sigmoid. ``fuse_hybrid`` turns gate weights into
rankable scores. The ``binary`` policy's mean runs over all columns, dead
ones included (``router/model.py:79``), as the reference does.

Train mode (``train=True``) repeats flax's: with ``update_stats`` the EMA
statistics move toward the batch's *before* the step normalizes with them,
and ``initialized`` becomes 1; ``Dropout`` keeps each unit with probability
``1 - rate`` from a ``torch.Generator`` and scales it by ``1 / (1 - rate)``;
``BatchNorm`` is flax's (momentum 0.99, epsilon 1e-5, the biased batch
variance ``E[x^2] - E[x]^2`` in the running statistics, not
``torch.nn.BatchNorm1d``'s unbiased one and momentum 0.1). Dropout masks
cannot match ``jax.random``'s, so the two packages agree in train mode only
at ``dropout = 0``.

``RetrievalRouter`` adds the reference's method surface;
``router/train.py`` trains, saves and loads it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from rag_uq_tpu_torch.core.config import RouterConfig
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.flax_nn import FlaxLeaf
from rag_uq_tpu_torch.ops.topk import stable_topk

_EPS = 1e-6
STAT_NAMES = ("bm25_mean", "bm25_std", "dense_mean", "dense_std", "initialized")


def normalize_towers(
    config: RouterConfig, bm25: torch.Tensor, dense: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query tower normalization before the gate and the fuse:
    "none" passes raw scores, "maxnorm" divides each tower by its per-query
    pool max (floored at 1e-12)."""
    if config.fuse_norm == "none":
        return bm25, dense
    if config.fuse_norm != "maxnorm":
        raise ValueError(f"Unknown fuse_norm: {config.fuse_norm!r}")
    b = bm25 / bm25.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    d = dense / dense.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return b, d


def fuse_hybrid(
    config: RouterConfig, weights: torch.Tensor, bm25: torch.Tensor,
    dense: torch.Tensor,
) -> torch.Tensor:
    """Deployment fuse: "soft" is w*dense + (1-w)*bm25; "binary" serves the
    pure tower the per-query mean gate picks (dense when the mean > 0.5)."""
    b, d = normalize_towers(config, bm25, dense)
    if config.gate_policy == "binary":
        wq = weights.mean(dim=-1, keepdim=True)
        return torch.where(wq > 0.5, d, b)
    if config.gate_policy != "soft":
        raise ValueError(f"Unknown gate_policy: {config.gate_policy!r}")
    return weights * d + (1.0 - weights) * b


def _sample_std(x: torch.Tensor) -> torch.Tensor:
    """Sample standard deviation (ddof=1) over all elements."""
    n = x.numel()
    var = ((x - x.mean()) ** 2).sum() / max(n - 1, 1)
    return var.sqrt()


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the batch axis of ``[N, C]``."""

    MOMENTUM, EPS = 0.99, 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.scale) + self.bias


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout`` in train mode, its mask drawn from ``gen``."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class RouterModule(nn.Module):
    """The gate MLP with its EMA score statistics as buffers."""

    def __init__(self, config: RouterConfig):
        super().__init__()
        if config.feature_set not in ("reference3", "pool7"):
            raise ValueError(f"Unknown feature_set: {config.feature_set!r}")
        self.config = config
        width = 7 if config.feature_set == "pool7" else 3
        self.hidden = nn.ModuleList()
        self.norms = nn.ModuleList()
        for _ in range(config.num_layers - 1):
            self.hidden.append(nn.Linear(width, config.hidden_dim))
            if config.use_batch_norm:
                self.norms.append(BatchNorm(config.hidden_dim))
            width = config.hidden_dim
        self.out = nn.Linear(width, 1)
        for name, value in zip(STAT_NAMES, (0.0, 1.0, 0.0, 1.0, 0.0)):
            self.register_buffer(name, torch.tensor(value))

    def flax_params(self) -> List[FlaxLeaf]:
        """The leaves of flax's ``params``: ``Dense_i`` (kernels ``[in, out]``)
        and, with batch norm, ``BatchNorm_i``."""
        leaves: List[FlaxLeaf] = []
        for i, layer in enumerate([*self.hidden, self.out]):
            d_out, d_in = layer.weight.shape
            leaves += [((f"Dense_{i}", "kernel"), layer.weight, (d_in, d_out), True),
                       ((f"Dense_{i}", "bias"), layer.bias, (d_out,), False)]
        for i, norm in enumerate(self.norms):
            dim = norm.scale.shape[0]
            leaves += [((f"BatchNorm_{i}", "scale"), norm.scale, (dim,), False),
                       ((f"BatchNorm_{i}", "bias"), norm.bias, (dim,), False)]
        return leaves

    def forward(self, bm25_scores: torch.Tensor, dense_scores: torch.Tensor,
                update_stats: bool = False, train: bool = False,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-passage gate weights [B, P] in [0, 1]; 1 favors dense."""
        b, d = normalize_towers(self.config, bm25_scores.float(), dense_scores.float())
        batch_b_mean, batch_b_std = b.mean(), _sample_std(b) + _EPS
        batch_d_mean, batch_d_std = d.mean(), _sample_std(d) + _EPS
        if update_stats and train:
            with torch.no_grad():
                m = self.config.ema_momentum
                for name, value in (("bm25_mean", batch_b_mean), ("bm25_std", batch_b_std),
                                    ("dense_mean", batch_d_mean), ("dense_std", batch_d_std)):
                    stat = getattr(self, name)
                    stat.copy_((1 - m) * stat + m * value)
                self.initialized.fill_(1.0)
        use_running = self.initialized > 0.5
        b_norm = torch.where(
            use_running,
            (b - self.bm25_mean) / (self.bm25_std + _EPS),
            (b - batch_b_mean) / (batch_b_std + _EPS),
        )
        d_norm = torch.where(
            use_running,
            (d - self.dense_mean) / (self.dense_std + _EPS),
            (d - batch_d_mean) / (batch_d_std + _EPS),
        )
        cols = [b_norm, d_norm, d_norm - b_norm]
        if self.config.feature_set == "pool7":
            # Within-pool z-scores and each tower's broadcast top1-top2 gap.
            n_p = b.shape[1]

            def row_stats(x):
                mean = x.mean(dim=1, keepdim=True)
                var = ((x - mean) ** 2).sum(dim=1, keepdim=True) / max(n_p - 1, 1)
                return mean, var.sqrt() + _EPS

            bp_mean, bp_std = row_stats(b)
            dp_mean, dp_std = row_stats(d)
            if n_p >= 2:
                b_top2 = stable_topk(b, 2)[0]
                d_top2 = stable_topk(d, 2)[0]
                b_gap = (b_top2[:, :1] - b_top2[:, 1:2]) / bp_std
                d_gap = (d_top2[:, :1] - d_top2[:, 1:2]) / dp_std
            else:
                b_gap = torch.zeros_like(bp_mean)
                d_gap = torch.zeros_like(dp_mean)
            cols += [
                (b - bp_mean) / bp_std,
                (d - dp_mean) / dp_std,
                b_gap.expand_as(b),
                d_gap.expand_as(d),
            ]
        x = torch.stack(cols, dim=-1).reshape(-1, len(cols))
        for i, layer in enumerate(self.hidden):
            x = layer(x)
            if self.norms:
                x = self.norms[i](x, train)
            x = torch.relu(x)
            if train:
                x = dropout(x, self.config.dropout, dropout_gen)
        return torch.sigmoid(self.out(x)).reshape(bm25_scores.shape)


class RetrievalRouter:
    """Holds a ``RouterModule`` (params and stats) on a device, in eval mode
    until ``train()``.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` at the
    flax initializers' scale (normal kernels with std 1/sqrt(fan_in), zero
    biases), or carried across from the JAX router with
    ``convert.load_router``.
    """

    def __init__(
        self, config: Optional[RouterConfig] = None, seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self._rebuild(config or RouterConfig(), seed)
        self._training = False

    def _rebuild(self, config: RouterConfig, seed: int = 0) -> None:
        """(Re)build the architecture with fresh weights in place, so a
        holder of this object sees a checkpoint of another architecture
        (``router/train.py``)."""
        self.config = config
        self.module = RouterModule(self.config)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in [*self.module.hidden, self.module.out]:
                fan_in = layer.weight.shape[1]
                layer.weight.copy_(
                    torch.randn(layer.weight.shape, generator=gen) / math.sqrt(fan_in)
                )
                layer.bias.zero_()
        self.module.to(self.device).eval()
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # Candidate-pool width the gate was trained on; serving clamps the
        # gate to it (retrieval/fused.py::fuse_pools_select).
        self.trained_num_passages: Optional[int] = None

    # -- torch-style mode switches -----------------------------------------------

    def train(self) -> "RetrievalRouter":
        self._training = True
        return self

    def eval(self) -> "RetrievalRouter":
        self._training = False
        return self

    @property
    def training(self) -> bool:
        return self._training

    @property
    def stats_initialized(self) -> bool:
        return bool(self.module.initialized > 0.5)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def __call__(self, bm25_scores, dense_scores, update_stats: bool = True):
        return self.forward(bm25_scores, dense_scores, update_stats)

    @torch.no_grad()
    def forward(self, bm25_scores, dense_scores, update_stats: bool = True) -> torch.Tensor:
        """Per-passage gating weights in [0, 1]; 1 favors dense retrieval.
        In train mode the EMA statistics (and batch norm's) move and
        dropout is drawn, as the JAX router's mutable apply does."""
        b = torch.as_tensor(bm25_scores, dtype=torch.float32, device=self.device)
        d = torch.as_tensor(dense_scores, dtype=torch.float32, device=self.device)
        if self._training:
            return self.module(b, d, update_stats=update_stats, train=True,
                               dropout_gen=self._dropout_gen)
        return self.module(b, d)

    def hybrid_rerank(
        self, bm25_scores, dense_scores, top_k: int = 10
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gate, fuse (``fuse_hybrid``), then the top-k: (scores [B, k],
        columns [B, k] int32), ties to the lowest column."""
        b = torch.as_tensor(bm25_scores, dtype=torch.float32, device=self.device)
        d = torch.as_tensor(dense_scores, dtype=torch.float32, device=self.device)
        hybrid = fuse_hybrid(self.config, self.forward(b, d, update_stats=False), b, d)
        vals, idx = stable_topk(hybrid, min(top_k, hybrid.shape[-1]))
        return vals, idx.to(torch.int32)

    def get_routing_decision(
        self, bm25_scores, dense_scores, threshold: float = 0.5
    ) -> Dict[str, Any]:
        """Interpretable routing statistics of the gate weights."""
        weights = self.forward(bm25_scores, dense_scores, update_stats=False).cpu().numpy()
        return {
            "avg_dense_weight": float(weights.mean()),
            "weight_std": float(weights.std(ddof=1)) if weights.size > 1 else 0.0,
            "dense_preferred_ratio": float((weights > threshold).mean()),
            "bm25_preferred_ratio": float((weights <= threshold).mean()),
            "routing_weights": weights,
        }
