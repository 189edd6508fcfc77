"""Fused hybrid query: the counterpart of ``rag_uq_tpu/retrieval/fused.py``.

One function from query vectors and term ids to the final top-k:

    dense top-pool      the cosine top-k kernel (CUDA) or its plain twin
    sparse top-pool     ``ops/bm25.py::topk_twotier`` (the default),
                        ``topk_lowscatter`` (scatter mode), or the exhaustive
                        ``score_all`` oracle (exact_bm25); a live-ingest
                        delta is scored exhaustively and merged in
    union merge         equality-matrix join; missing scores are 0.0
    fusion              the learned router's gate, or the reference's fixed
                        mean-of-max-normalized fusion
    final top-k

The dense pool on a CUDA tensor always goes through the kernel
(``ops/cosine_topk.py``), whatever exact ``dense_mode`` is named; on a CPU
tensor "stream" is the block-streamed twin and every other mode the single
product. Every sort that decides an order is stable, so ties resolve as
``lax.top_k`` and the numpy eval protocol resolve them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.ops import bm25 as bm25_ops
from rag_uq_tpu_torch.ops.cosine_topk import cuda_cosine_topk
from rag_uq_tpu_torch.ops.topk import cosine_topk, cosine_topk_single, stable_topk
from rag_uq_tpu_torch.router.model import RouterModule, fuse_hybrid

_INT_MAX = torch.iinfo(torch.int32).max


def _argsort(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=descending, stable=True).indices


def union_dedup(positions: torch.Tensor) -> torch.Tensor:
    """Sort-based dedup of doc positions per row; dups/dead become -1."""
    mapped = torch.where(positions >= 0, positions, _INT_MAX)
    s = torch.sort(mapped, dim=-1).values
    prev = torch.cat([torch.full_like(s[..., :1], -1), s[..., :-1]], dim=-1)
    keep = (s != prev) & (s != _INT_MAX)
    return torch.where(keep, s, -1)


def merge_pools(
    bvals: torch.Tensor, bidx: torch.Tensor, dvals: torch.Tensor, didx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union the two pools with aligned per-doc score columns.

    Docs in both pools collapse onto the dense entry, which receives the
    BM25 score; scores missing from a pool are 0.0. Returns
    (positions [B, Pb+Pd], bm25_col, dense_col).
    """
    live_d = didx >= 0
    live_b = bidx >= 0
    eq = (didx[:, :, None] == bidx[:, None, :]) & live_d[:, :, None] & live_b[:, None, :]
    # At most one match per row of eq, so this sum is exact.
    bm25_for_dense = (eq.to(bvals.dtype) * bvals[:, None, :]).sum(dim=-1)
    b_is_dup = eq.any(dim=1)
    positions = torch.cat([didx, torch.where(b_is_dup, -1, bidx)], dim=-1)
    dense_col = torch.cat(
        [torch.where(live_d, dvals, 0.0), torch.zeros_like(bvals)], dim=-1
    )
    bm25_col = torch.cat(
        [bm25_for_dense, torch.where(b_is_dup | ~live_b, 0.0, bvals)], dim=-1
    )
    return positions, bm25_col, dense_col


def _max_norm_fusion(bm25: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    max_b = bm25.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    max_d = dense.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return (bm25 / max_b + dense / max_d) / 2.0


def fuse_pools_select(
    bvals: torch.Tensor, bidx: torch.Tensor, dvals: torch.Tensor, didx: torch.Tensor,
    k: int, router_module: Optional[RouterModule] = None,
    router_width: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union-merge the pools, fuse (router or fixed), select the final top-k.

    ``router_width`` clamps the gate to the pool width it was trained on
    (see ``_router_head_select``).
    """
    positions, bm25_scores, dense_scores = merge_pools(bvals, bidx, dvals, didx)
    live = positions >= 0
    if router_module is not None:
        m = bm25_scores.shape[-1]
        w = min(router_width or m, m)
        if w < m:
            return _router_head_select(
                positions, bm25_scores, dense_scores, live, k, w, router_module
            )
        weights = router_module(bm25_scores, dense_scores)
        hybrid = fuse_hybrid(router_module.config, weights, bm25_scores, dense_scores)
    else:
        hybrid = _max_norm_fusion(bm25_scores, dense_scores)
    hybrid = torch.where(live, hybrid, float("-inf"))
    vals, sel = stable_topk(hybrid, k)
    out_pos = torch.gather(positions, -1, sel)
    dead = torch.isneginf(vals)
    return torch.where(dead, 0.0, vals), torch.where(dead, -1, out_pos)


def _router_head_select(
    positions: torch.Tensor, bm25_scores: torch.Tensor, dense_scores: torch.Tensor,
    live: torch.Tensor, k: int, w: int, router_module: RouterModule,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced-head router rerank at the trained width (``fused.py:138``).

    Select the w-member head by best single-tower rank (fused-score
    tiebreak), present it in fixed-fusion order, gate only the head, and
    rank every other member after it in fixed-fusion order. Returned scores
    are the max-normalized fixed-fusion scores; the order is the policy's.
    """
    m = positions.shape[-1]
    head, gated, fused_s = router_head_scores(
        bm25_scores, dense_scores, live, w, router_module)
    # Rank keys: head members take 0..w-1 by gated score, every other member
    # w + its fused rank; dead columns sink.
    rank_in_head = _argsort(_argsort(-gated))
    rank_fused = _argsort(_argsort(-fused_s))
    key = (w + rank_fused).scatter(-1, head, rank_in_head)
    key = torch.where(live, key, 2 * m + w)
    sel_k = _argsort(key)[..., :k]
    out_pos = torch.gather(positions, -1, sel_k)
    out_vals = torch.gather(fused_s, -1, sel_k)
    out_live = torch.gather(live, -1, sel_k)
    return torch.where(out_live, out_vals, 0.0), torch.where(out_live, out_pos, -1)


def router_head_scores(
    bm25_scores: torch.Tensor, dense_scores: torch.Tensor, live: torch.Tensor,
    w: int, router_module: RouterModule,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's head over a merged pool: (head columns [B, w] in
    fixed-fusion order, their gated scores [B, w], every column's
    max-normalized fixed-fusion score [B, M], -inf where dead)."""
    neg = float("-inf")
    m = bm25_scores.shape[-1]
    b_live = torch.where(live, bm25_scores, neg)
    d_live = torch.where(live, dense_scores, neg)
    max_b = b_live.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    max_d = d_live.amax(dim=-1, keepdim=True).clamp(min=1e-12)
    fused_s = torch.where(live, (bm25_scores / max_b + dense_scores / max_d) / 2.0, neg)
    rank_b = _argsort(_argsort(-b_live))
    rank_d = _argsort(_argsort(-d_live))
    min_rank = torch.where(live, torch.minimum(rank_b, rank_d), m + 1)
    # lexsort((-fused_s, min_rank)): primary min_rank, secondary -fused_s.
    by_fused = _argsort(-fused_s)
    sel = torch.gather(by_fused, -1, _argsort(torch.gather(min_rank, -1, by_fused)))
    sel = sel[..., :w]
    sel_fused = torch.gather(fused_s, -1, sel)
    head = torch.gather(sel, -1, _argsort(-sel_fused))
    h_live = torch.gather(live, -1, head)
    hb = torch.where(h_live, torch.gather(bm25_scores, -1, head), 0.0)
    hd = torch.where(h_live, torch.gather(dense_scores, -1, head), 0.0)
    weights = router_module(hb, hd)
    gated = torch.where(h_live, fuse_hybrid(router_module.config, weights, hb, hd), neg)
    return head, gated, fused_s


def dense_pool(
    emb: torch.Tensor, q_vecs: torch.Tensor, size: int, pool: int,
    dense_mode: str = "single", block: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense top-pool: the CUDA kernel on a card, the plain twin on CPU."""
    if emb.device.type == "cuda":
        return cuda_cosine_topk(emb, q_vecs, size, pool)
    if dense_mode == "stream":
        return cosine_topk(emb, q_vecs, size, pool, block)
    return cosine_topk_single(emb, q_vecs, size, pool)


def make_fused_hybrid_query(
    router_module: Optional[RouterModule] = None,
    router_width: Optional[int] = None,
    k: int = 10,
    pool: int = 50,
    block: int = 8192,
    beam: int = 128,
    approx_topk: bool = True,
    exact_bm25: bool = False,
    dense_mode: str = "single",  # "single" | "single_approx" | "stream" | "pallas"
    max_df: Optional[int] = None,  # REQUIRED with exact_bm25 (index max df)
    nonneg: bool = True,  # pass the index's dev["nonneg"] flag
    delta_cap: int = 0,  # live-ingest delta doc capacity (0 = no delta)
    delta_max_df: int = 0,
    sparse_mode: str = "twotier",  # "twotier" | "scatter"
    lsel: int = 4096,  # twotier low-tier truncation under approx_topk (0 = off)
) -> Callable[[Dict[str, Any], torch.Tensor, Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor]]:
    """Build fn(index_state, q_vecs, qterms) -> (scores [B, k], positions [B, k]).

    ``index_state`` is the dict from ``build_index_state``, ``qterms`` the
    dict from ``encode_for_fused``; the router, if any, is ``router_module``.
    ``approx_topk`` has no PyTorch counterpart (``lax.approx_max_k``): every
    top-k here is exact; it still turns on the twotier ``lsel`` truncation,
    as in the JAX package. A state with a live delta (``build_index_state``
    with ``allow_delta``) needs the matching ``delta_cap``/``delta_max_df``.
    """
    if exact_bm25 and max_df is None:
        raise ValueError(
            "exact_bm25=True needs max_df=bm25_index._sync()['max_df'] — a "
            "default cap would silently truncate postings of common terms"
        )
    if sparse_mode not in ("twotier", "scatter"):
        raise ValueError(f"unknown sparse_mode {sparse_mode!r}")
    if dense_mode not in ("single", "single_approx", "stream", "pallas"):
        raise ValueError(f"unknown dense_mode {dense_mode!r}")

    @torch.no_grad()
    def fused(state: Dict[str, Any], q_vecs: torch.Tensor, qterms: Dict[str, torch.Tensor]):
        emb = state["emb"]
        dvals, didx = dense_pool(emb, q_vecs, state["size"], pool, dense_mode, block)
        dvals = torch.where(didx >= 0, dvals, 0.0)
        if exact_bm25:
            all_scores = bm25_ops.score_all(
                state["indptr"], state["post_doc"], state["post_w"],
                qterms["qtids"], emb.shape[0], max_df,
            )
            bvals, bidx = bm25_ops.topk_from_scores(all_scores, pool)
        else:
            if sparse_mode == "scatter":
                bvals, bidx = bm25_ops.topk_lowscatter(
                    state["low_ranges"], state["post_packed"],
                    state["term_row"], state["impact"],
                    qterms["qtids_base"], pool, beam=beam, approx=approx_topk,
                    impact_scale=state["impact_scale"],
                    active_rows=qterms.get("active_rows"),
                    rows_compact=qterms.get("rows_compact"),
                    low_blocks=state.get("low_blocks"),
                    low_row=state.get("low_row"),
                )
            else:
                bvals, bidx = bm25_ops.topk_twotier(
                    state["low_ranges"], state["post_packed"],
                    state["term_row"], state["impact"],
                    qterms["qtids_base"], pool, beam=beam, approx=approx_topk,
                    lsel=lsel if approx_topk else 0,
                    impact_scale=state["impact_scale"], nonneg=nonneg,
                )
            if "delta_indptr" in state:
                # Live-ingest delta: score the recently added docs
                # exhaustively (few) and merge them into the BM25 pool.
                dscores = bm25_ops.score_all(
                    state["delta_indptr"], state["delta_post_doc"],
                    state["delta_post_w"], qterms["qtids"], delta_cap, delta_max_df,
                )
                dv, di = bm25_ops.topk_from_scores(dscores, min(pool, delta_cap))
                di = torch.where(di >= 0, di + state["delta_base_docs"], -1)
                cat_v = torch.cat([bvals, dv], dim=-1)
                cat_i = torch.cat([bidx, di], dim=-1)
                bvals, sel = stable_topk(cat_v, pool)
                bidx = torch.gather(cat_i, -1, sel)
            dead = bvals <= 0.0
            bvals = torch.where(dead, 0.0, bvals)
            bidx = torch.where(dead, -1, bidx)
        return fuse_pools_select(
            bvals, bidx, dvals, didx, k,
            router_module=router_module, router_width=router_width,
        )

    return fused


def _next_pow2_host(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def encode_for_fused(
    bm25_index, queries, active_compaction: bool = False
) -> Dict[str, torch.Tensor]:
    """Encode a query batch into the fused query's term inputs.

    ``qtids_base`` clamps term ids beyond the synced vocabulary capacity.
    With ``active_compaction``, also emits ``active_rows`` (the pow2-bucketed,
    0-padded dense-tier impact rows any query in the batch touches) and
    ``rows_compact`` (each query slot's compact row, or -1).
    """
    device = bm25_index.device
    qtids = bm25_index.encode_queries(queries)
    base_dev = bm25_index._device
    if base_dev is not None:
        base_vcap = base_dev["indptr"].shape[0] - 1
        qtids_base = np.where(qtids < base_vcap, qtids, -1)
    else:
        qtids_base = qtids
    out = {
        "qtids": torch.from_numpy(qtids).to(device),
        "qtids_base": torch.from_numpy(np.ascontiguousarray(qtids_base)).to(device),
    }
    if active_compaction and base_dev is not None:
        host_term_row = bm25_index._term_row_host
        safe = np.where(qtids_base >= 0, qtids_base, 0)
        rows = np.where(qtids_base >= 0, host_term_row[safe], -1)
        uniq = np.unique(rows[rows >= 0])
        ta_cap = int(_next_pow2_host(max(uniq.shape[0], 1), floor=64))
        active = np.zeros(ta_cap, dtype=np.int32)
        active[: uniq.shape[0]] = uniq
        remap = np.full(base_dev["impact"].shape[0], -1, dtype=np.int32)
        remap[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
        rows_compact = np.where(rows >= 0, remap[np.maximum(rows, 0)], -1)
        out["active_rows"] = torch.from_numpy(active).to(device)
        out["rows_compact"] = torch.from_numpy(rows_compact.astype(np.int32)).to(device)
    return out


def build_index_state(dense_index, bm25_index, allow_delta: bool = False) -> Dict[str, Any]:
    """Collect the two indices' device tensors into one state dict.

    With ``allow_delta`` (and ``delta_sync_fraction > 0``) a live delta is
    kept or built instead of forcing a full resync; its arrays join the
    state, and the fused query needs the matching ``delta_cap``/``delta_max_df``.
    """
    if allow_delta:
        dev, delta = bm25_index._sync_incremental()
    else:
        dev, delta = bm25_index._require_full_sync(), None
    state = {"emb": dense_index._emb, "size": len(dense_index)}
    for name in ("indptr", "post_doc", "post_w", "low_ranges", "post_packed",
                 "term_row", "impact", "impact_scale", "low_blocks", "low_row"):
        if name in dev:
            state[name] = dev[name]
    if delta is not None:
        state.update(
            delta_indptr=delta["indptr"],
            delta_post_doc=delta["post_doc"],
            delta_post_w=delta["post_w"],
            delta_base_docs=delta["base_docs"],
        )
    return state
