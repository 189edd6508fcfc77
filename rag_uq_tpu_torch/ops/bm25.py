"""BM25 scoring over CSR postings: the counterpart of ``rag_uq_tpu/ops/bm25.py``.

The index layout is the JAX package's (term-major CSR with precomputed
per-posting impacts, plus the two-tier layout of ``index/sparse.py``).
Ported here: the exhaustive ``score_all`` oracle, ``score_docs`` for given
docs, ``topk_from_scores`` and both pool ops, ``topk_twotier`` (the JAX
default) and the scatter-mode ``topk_lowscatter``. On the TPU these are XLA,
not Pallas; here they are plain PyTorch.

Query term ids are padded with -1 (no contribution); repeated query terms
count once per occurrence, as in ``rank_bm25``'s ``get_scores``. Top-k takes
value descending, then lowest doc, as ``lax.top_k`` does.

``scatter_add_`` has no ``mode="drop"`` (``ops/bm25.py:369-372,418``), so
the totals carry one spare column that the out-of-range padding entries
(doc = ``n_docs_cap``, ``index/sparse.py:436-438``) land in, and the column
is sliced off before the top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_uq_tpu_torch.ops.topk import stable_topk


def _term_ranges(
    indptr: torch.Tensor, qtids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) postings ranges per query slot; empty for padding."""
    valid = qtids >= 0
    safe = torch.where(valid, qtids, 0).long()
    start = torch.where(valid, indptr[safe], 0)
    end = torch.where(valid, indptr[safe + 1], 0)
    return start, end


def _segment_searchsorted(
    post_doc: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """First index in [start, end) with post_doc[i] >= target (binary search)."""
    pcap = post_doc.shape[0]
    lo, hi, target = torch.broadcast_tensors(start, end, target)
    lo, hi = lo.clone(), hi.clone()
    for _ in range(32):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = post_doc[mid.clamp(0, pcap - 1).long()]
        less = v < target
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def score_all(
    indptr: torch.Tensor, post_doc: torch.Tensor, post_w: torch.Tensor,
    qtids: torch.Tensor, n_docs_cap: int, max_df: int,
) -> torch.Tensor:
    """Exhaustive BM25 scores [B, n_docs_cap] (exact, scatter-add)."""
    pcap = post_doc.shape[0]
    nq = qtids.shape[0]
    off = torch.arange(max_df, dtype=torch.int32, device=qtids.device)
    start, end = _term_ranges(indptr, qtids)  # [B, Lq]
    idx = start[..., None] + off  # [B, Lq, max_df]
    ok = off < (end - start)[..., None]
    idx = idx.clamp(0, pcap - 1).long()
    docs = torch.where(ok, post_doc[idx], 0)  # masked entries add 0.0 to doc 0
    w = torch.where(ok, post_w[idx], 0.0)
    scores = torch.zeros((nq, n_docs_cap), dtype=torch.float32, device=qtids.device)
    return scores.scatter_add_(1, docs.reshape(nq, -1).long(), w.reshape(nq, -1))


def score_docs(
    indptr: torch.Tensor, post_doc: torch.Tensor, post_w: torch.Tensor,
    qtids: torch.Tensor, doc_positions: torch.Tensor,
) -> torch.Tensor:
    """Exact BM25 scores [B, P] for specific docs (-1 padded -> 0.0)."""
    pcap = post_doc.shape[0]
    start, end = _term_ranges(indptr, qtids)  # [B, Lq]
    target = doc_positions.clamp(min=0)[:, None, :]  # [B, 1, P]
    lo = _segment_searchsorted(
        post_doc, start[..., None], end[..., None], target
    )  # [B, Lq, P]
    at = lo.clamp(0, pcap - 1).long()
    hit = (lo < end[..., None]) & (post_doc[at] == target)
    total = torch.where(hit, post_w[at], 0.0).sum(dim=1)  # [B, P]
    return torch.where(doc_positions >= 0, total, 0.0)


_DOC_SENTINEL = torch.iinfo(torch.int32).max


def _low_tier_segsum(
    low_ranges: torch.Tensor,  # [2, Vcap] explicit (start, end) per term
    post_packed: torch.Tensor,  # [2, Pcap] int32: (doc, bitcast f32 weight)
    qtids: torch.Tensor,  # [B, Lq]
    beam: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query low-tier contributions grouped by doc (``ops/bm25.py:131``).

    Each low-tier query term's postings (at most ``beam`` by construction)
    come from one slice of the packed array; the ``Lq * beam`` pool is sorted
    by doc (stably, as ``jnp.argsort``) and each run of equal docs summed by
    shift-window sums, in the reference's order. Returns (docs [B, Lq*beam],
    sums [B, Lq*beam]); slots that are not the last of a run have doc -1 and
    sum -inf.
    """
    pcap = post_packed.shape[1]
    nq, n_terms = qtids.shape
    dev = qtids.device
    valid = qtids >= 0
    safe = torch.where(valid, qtids, 0).long()
    start = torch.where(valid, low_ranges[0][safe], 0)
    end = torch.where(valid, low_ranges[1][safe], 0)
    safe_start = start.clamp(max=max(pcap - beam, 0))
    off = torch.arange(beam, device=dev)
    pos = safe_start[..., None] + off  # [B, Lq, beam]
    at = pos.clamp(max=pcap - 1).long()
    ok = (pos >= start[..., None]) & (pos < end[..., None])
    docs = torch.where(ok, post_packed[0][at], _DOC_SENTINEL).reshape(nq, -1)
    w = torch.where(ok, post_packed[1].view(torch.float32)[at], 0.0).reshape(nq, -1)

    order = torch.sort(docs, dim=-1, stable=True).indices
    docs = torch.gather(docs, -1, order)
    w = torch.gather(w, -1, order)
    # A doc appears at most once per query term, so a run of equal docs is
    # at most Lq long: its total at its last slot sums the Lq - 1 before it.
    run_total = w
    for shift in range(1, n_terms):
        shifted_docs = torch.cat([torch.full_like(docs[:, :shift], -2), docs[:, :-shift]], dim=-1)
        shifted_w = torch.cat([torch.zeros_like(w[:, :shift]), w[:, :-shift]], dim=-1)
        run_total = run_total + torch.where(shifted_docs == docs, shifted_w, 0.0)
    nxt = torch.cat([docs[:, 1:], torch.full_like(docs[:, :1], _DOC_SENTINEL)], dim=-1)
    last = (docs != nxt) & (docs != _DOC_SENTINEL)
    return torch.where(last, docs, -1), torch.where(last, run_total, float("-inf"))


def topk_twotier(
    low_ranges: torch.Tensor,  # [2, Vcap] (start, end), emptied for dense tier
    post_packed: torch.Tensor,  # [2, Pcap] packed (doc, bitcast weight)
    term_row: torch.Tensor,  # [Vcap] -> dense-tier row id or -1
    impact: torch.Tensor,  # [T_cap, Ncap] per-doc impacts of dense-tier terms
    qtids: torch.Tensor,  # [B, Lq]
    k: int,
    beam: int,
    approx: bool = False,
    lsel: int = 0,
    impact_scale: Optional[torch.Tensor] = None,  # [T_cap] per-row int8 scales
    nonneg: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 top-k by two-tier scoring (``ops/bm25.py:189-295``).

    High-df terms contribute H for every doc through one product of a query
    one-hot (counting repeated terms; the int8 row scales folded in) with the
    [T, N] impact matrix; low-df terms are segment-summed per doc (L). The
    top-k of H + L lies in top-k(H) and the L candidates, so the result is
    the top-k over ``concat([top-k(H) without the L docs, L + H at them])``;
    ties there go to the earlier slot of that concatenation, as ``lax.top_k``
    sends them (a stable top-k), not to the lowest doc. With ``nonneg=False``
    (negative low-tier impacts break that containment) L is scattered into H
    and one top-k runs over the totals. ``lsel > 0`` keeps only the ``lsel``
    largest low-tier sums (an approximation the callers take only with
    ``approx``). ``approx=True`` (``lax.approx_max_k``) has no PyTorch
    counterpart: every top-k here is exact. The high-tier product is taken
    in f32 from the storage-dtype values, as in ``topk_lowscatter``.
    Returns (scores [B, k], doc positions [B, k]); callers apply the
    positive-scores-only contract.
    """
    del approx
    tcap, ncap = impact.shape
    nq = qtids.shape[0]
    dev = qtids.device
    valid_q = qtids >= 0
    safe_q = torch.where(valid_q, qtids, 0).long()
    rows = torch.where(valid_q, term_row[safe_q], -1).long()  # [B, Lq]
    b_ix = torch.arange(nq, device=dev)[:, None]

    onehot_dtype = torch.bfloat16 if impact.dtype == torch.int8 else impact.dtype
    onehot = torch.zeros((nq, tcap + 1), dtype=onehot_dtype, device=dev)
    onehot.index_put_(
        (b_ix.expand_as(rows), torch.where(rows >= 0, rows, tcap)),
        torch.ones(rows.shape, dtype=onehot_dtype, device=dev),
        accumulate=True,
    )
    onehot = onehot[:, :tcap]
    if impact_scale is not None:
        onehot = onehot * impact_scale.to(onehot_dtype)[None, :]
    high = torch.matmul(onehot.float(), impact.to(onehot_dtype).float())  # [B, N]

    ldocs, lsums = _low_tier_segsum(low_ranges, post_packed, qtids, beam)
    if lsel and ldocs.shape[-1] > lsel:
        lsums, sel = stable_topk(lsums, lsel)
        ldocs = torch.gather(ldocs, -1, sel)

    safe_docs = ldocs.clamp(0, ncap - 1).long()
    if not nonneg:
        add = torch.where(ldocs >= 0, lsums, 0.0)
        total = high.scatter_add(1, safe_docs, add)
        vals, docs = stable_topk(total, k)
        return vals, docs.to(torch.int32)

    ltot = torch.where(ldocs >= 0, lsums + torch.gather(high, -1, safe_docs), float("-inf"))
    hv, hi = stable_topk(high, k)
    # Drop H-only entries that an L-augmented total supersedes.
    dup = (hi[:, :, None] == torch.where(ldocs >= 0, ldocs, -7).long()[:, None, :]).any(dim=-1)
    hv = torch.where(dup, float("-inf"), hv)
    cat_v = torch.cat([hv, ltot], dim=-1)
    cat_i = torch.cat([hi, ldocs.long()], dim=-1)
    vals, sel = stable_topk(cat_v, k)
    docs = torch.gather(cat_i, -1, sel)
    dead = torch.isneginf(vals)
    return torch.where(dead, 0.0, vals), torch.where(dead, -1, docs).to(torch.int32)


def topk_lowscatter(
    low_ranges: torch.Tensor,  # [2, Vcap] (start, end), emptied for dense tier
    post_packed: torch.Tensor,  # [2, Pcap] packed (doc, bitcast weight)
    term_row: torch.Tensor,  # [Vcap] -> dense-tier row id or -1
    impact: torch.Tensor,  # [T_cap, Ncap] per-doc impacts of dense-tier terms
    qtids: torch.Tensor,  # [B, Lq]
    k: int,
    beam: int,
    approx: bool = False,
    impact_scale: Optional[torch.Tensor] = None,  # [T_cap] per-row int8 scales
    active_rows: Optional[torch.Tensor] = None,  # [Ta_cap] batch-active rows
    rows_compact: Optional[torch.Tensor] = None,  # [B, Lq] compact slot or -1
    low_blocks: Optional[torch.Tensor] = None,  # [Lcap, 2, beam] padded blocks
    low_row: Optional[torch.Tensor] = None,  # [Vcap] -> block row (pad = last)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-tier BM25 top-k via a low-tier scatter-add (exact for any sign).

    High-df terms contribute through one product of a query one-hot (scaled
    per row for int8 impacts) with the [T, N] impact matrix; the raw
    (doc, weight) postings of low-df terms are scatter-added into those
    totals; one top-k runs over the result. With ``active_rows`` and
    ``rows_compact`` the product runs on the batch's active rows only; with
    ``low_blocks``/``low_row`` the low tier is one row gather, else one
    slice of ``post_packed`` per (query, term).

    ``approx=True`` is ``lax.approx_max_k`` on the TPU, which has no
    PyTorch counterpart: here it computes the exact top-k. Callers apply the
    positive-scores-only contract.
    """
    del approx
    ncap = impact.shape[1]
    pcap = post_packed.shape[1]
    nq = qtids.shape[0]
    dev = qtids.device
    valid_q = qtids >= 0
    safe_q = torch.where(valid_q, qtids, 0).long()
    b_ix = torch.arange(nq, device=dev)[:, None]

    # High tier. The one-hot and impacts are bf16 values (or int8 promoted
    # to bf16, as on the TPU); their products are exact in f32, so taking
    # the product in f32 matches the TPU's bf16 x bf16 -> f32 product up to
    # the order of its short sums.
    onehot_dtype = torch.bfloat16 if impact.dtype == torch.int8 else impact.dtype
    if active_rows is not None and rows_compact is not None:
        t_active = active_rows.shape[0]
        rows = active_rows.long()
        sub_impact = impact[rows]  # [Ta_cap, N]
        if impact_scale is not None:
            scale_slot = impact_scale[rows][rows_compact.clamp(min=0).long()]
        else:
            scale_slot = torch.ones(rows_compact.shape, dtype=torch.float32, device=dev)
        # Dead slots go to a spare column t_active that is dropped after.
        rc = torch.where(rows_compact >= 0, rows_compact, t_active).long()
        onehot = torch.zeros((nq, t_active + 1), dtype=onehot_dtype, device=dev)
        onehot.index_put_(
            (b_ix.expand_as(rc), rc), scale_slot.to(onehot_dtype), accumulate=True
        )
        onehot = onehot[:, :t_active]
    else:
        tcap = impact.shape[0]
        rows = torch.where(valid_q, term_row[safe_q], -1).long()
        onehot = torch.zeros((nq, tcap + 1), dtype=onehot_dtype, device=dev)
        onehot.index_put_(
            (b_ix.expand_as(rows), torch.where(rows >= 0, rows, tcap)),
            torch.ones(rows.shape, dtype=onehot_dtype, device=dev),
            accumulate=True,
        )
        onehot = onehot[:, :tcap]
        if impact_scale is not None:
            onehot = onehot * impact_scale.to(onehot_dtype)[None, :]
        sub_impact = impact
    total = torch.zeros((nq, ncap + 1), dtype=torch.float32, device=dev)
    torch.matmul(
        onehot.float(), sub_impact.to(onehot_dtype).float(), out=total[:, :ncap]
    )

    # Low tier: posting entries scattered into the totals.
    if low_blocks is not None and low_row is not None:
        pad_row = low_blocks.shape[0] - 1
        brows = torch.where(valid_q, low_row[safe_q], pad_row).long()
        sl = low_blocks[brows]  # [B, Lq, 2, beam]
        docs = sl[:, :, 0, :].reshape(nq, -1)
        w = sl.view(torch.float32)[:, :, 1, :].reshape(nq, -1)
    else:
        start = torch.where(valid_q, low_ranges[0][safe_q], 0)
        end = torch.where(valid_q, low_ranges[1][safe_q], 0)
        safe_start = start.clamp(max=max(pcap - beam, 0))
        off = torch.arange(beam, device=dev)
        pos = safe_start[..., None] + off  # [B, Lq, beam]
        at = pos.clamp(max=pcap - 1).long()
        docs = post_packed[0][at]
        w = post_packed[1].view(torch.float32)[at]
        ok = (pos >= start[..., None]) & (pos < end[..., None])
        docs = torch.where(ok, docs, 0).reshape(nq, -1)  # masked -> add 0.0
        w = torch.where(ok, w, 0.0).reshape(nq, -1)
    total.scatter_add_(1, docs.long(), w)
    vals, idx = stable_topk(total[:, :ncap], k)
    return vals, idx.to(torch.int32)


def topk_from_scores(
    scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over score rows; 0.0 and -1 for non-positive-score slots
    (the reference's positive-scores-only contract,
    ``streaming_index.py:172-179``)."""
    vals, idx = stable_topk(scores, k)
    dead = vals <= 0.0
    return torch.where(dead, 0.0, vals), torch.where(dead, -1, idx).to(torch.int32)
