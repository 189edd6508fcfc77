"""Exact cosine top-k in plain PyTorch: the counterpart of ``rag_uq_tpu/ops/topk.py``.

Every top-k here orders by value descending, then lowest index, as
``jax.lax.top_k`` does (``rag_uq_tpu/ops/topk.py:31-32``). ``torch.topk``
does not promise that order among equal values, so ``stable_topk`` takes a
stable descending sort and slices it. Queries are cast to the corpus dtype
before the product, which accumulates in f32 (``ops/topk.py:100-102``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lowest index (int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_topk_single(
    emb: torch.Tensor, queries: torch.Tensor, size: int, k: int,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One [B, cap] product, then an exact top-k.

    The product is taken in f32 from the corpus-dtype values, which is exact
    per term for bf16 operands, as the TPU's f32 accumulation is.
    ``approx=True`` (``lax.approx_max_k`` on the TPU) has no PyTorch
    counterpart; it computes the exact top-k as well.
    """
    del approx
    cap = emb.shape[0]
    scores = torch.matmul(queries.to(emb.dtype).float(), emb.float().T)
    col = torch.arange(cap, device=emb.device)
    scores = scores.masked_fill(col[None, :] >= size, float("-inf"))
    vals, idx = stable_topk(scores, k)
    idx = torch.where(torch.isneginf(vals), -1, idx)
    return vals, idx.to(torch.int32)


def cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, size: int, k: int,
    block: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-streamed exact top-k with a running merge (never [B, cap] at once).

    Same contract as ``cosine_topk_single``: (scores [B, k] f32, rows [B, k]
    int32), -1 and -inf in dead slots.
    """
    cap, _ = emb.shape
    if cap % block != 0:
        raise ValueError(f"capacity {cap} must be a multiple of block {block}")
    if k > block:
        raise ValueError(f"k={k} must be <= block={block}")
    q = queries.to(emb.dtype).float()
    n_q = q.shape[0]
    col = torch.arange(block, device=emb.device)
    best_v = torch.full((n_q, k), float("-inf"), device=emb.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=emb.device)
    for base in range(0, cap, block):
        scores = torch.matmul(q, emb[base : base + block].float().T)
        scores = scores.masked_fill((base + col)[None, :] >= size, float("-inf"))
        v, i = stable_topk(scores, k)
        # The running buffer (earlier blocks, lower rows) goes first, so the
        # stable merge keeps lowest-index tie-breaking.
        cat_v = torch.cat([best_v, v], dim=-1)
        cat_i = torch.cat([best_i, i + base], dim=-1)
        best_v, sel = stable_topk(cat_v, k)
        best_i = torch.gather(cat_i, -1, sel)
    best_i = torch.where(torch.isneginf(best_v), -1, best_i)
    return best_v, best_i.to(torch.int32)


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor,
    vals_b: torch.Tensor, idx_b: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k result sets into one (``a`` wins ties)."""
    cat_v = torch.cat([vals_a, vals_b], dim=-1)
    cat_i = torch.cat([idx_a, idx_b], dim=-1)
    nv, sel = stable_topk(cat_v, k)
    return nv, torch.gather(cat_i, -1, sel)


def gather_scores(
    emb: torch.Tensor, queries: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Cosine scores of queries [B, D] against rows positions [B, P].

    Invalid positions (< 0) score 0.0 (``streaming_index.py:498-499``).
    """
    rows = emb[positions.clamp(min=0).long()].float()  # [B, P, D]
    q = queries.to(emb.dtype).float()
    scores = torch.einsum("bd,bpd->bp", q, rows)
    return torch.where(positions >= 0, scores, torch.zeros_like(scores))
