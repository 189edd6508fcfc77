"""Differentiable ApproxNDCG listwise ranking loss: the counterpart of
``rag_uq_tpu/router/loss.py``.

Soft ranks ``1 + sum_j sigmoid((s_j - s_i) / tau) - 0.5``, DCG gains
``2^rel - 1``, discounts ``log2(1 + rank)``, NDCG = DCG / (IDCG + 1e-10) with
the ideal DCG from the relevances sorted descending, loss = -mean NDCG.
Masked items are left out of the pairwise sums and carry no gain, so masked
losses stay finite (the reference's -inf fill makes them NaN).
"""

from __future__ import annotations

from typing import Optional

import torch


def approx_ndcg_loss(
    predicted_scores: torch.Tensor,  # [B, P]
    relevance_labels: torch.Tensor,  # [B, P], >= 0
    mask: Optional[torch.Tensor] = None,  # [B, P] bool, True = real item
    temperature: float = 1.0,
) -> torch.Tensor:
    """Scalar loss = negative mean ApproxNDCG."""
    scores = predicted_scores.float()
    rels = relevance_labels.float()
    if mask is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    else:
        valid = mask.bool()
        rels = torch.where(valid, rels, torch.zeros_like(rels))

    diff = scores[..., None, :] - scores[..., :, None]  # [B, P(i), P(j)] = s_j - s_i
    pair_valid = valid[..., None, :] & valid[..., :, None]
    probs = torch.where(pair_valid, torch.sigmoid(diff / temperature), torch.zeros_like(diff))
    approx_ranks = 1.0 + probs.sum(dim=-1) - 0.5
    approx_ranks = torch.where(valid, approx_ranks, torch.ones_like(approx_ranks))

    gains = torch.pow(2.0, rels) - 1.0
    dcg = torch.where(valid, gains / torch.log2(1.0 + approx_ranks), torch.zeros_like(gains)).sum(-1)

    sorted_rels = torch.sort(rels, dim=-1, descending=True).values
    ideal_ranks = torch.arange(1, rels.shape[-1] + 1, dtype=torch.float32, device=rels.device)
    idcg = ((torch.pow(2.0, sorted_rels) - 1.0) / torch.log2(1.0 + ideal_ranks)).sum(-1)
    return -(dcg / (idcg + 1e-10)).mean()


class ApproxNDCGLoss:
    """Callable wrapper with the reference's class surface."""

    def __init__(self, temperature: float = 1.0):
        self.temperature = temperature

    def __call__(self, predicted_scores, relevance_labels, mask=None) -> torch.Tensor:
        return approx_ndcg_loss(torch.as_tensor(predicted_scores), torch.as_tensor(relevance_labels),
                                None if mask is None else torch.as_tensor(mask), self.temperature)

    forward = __call__
