"""The two-tier BM25 device layout, for one device and for a corpus in shards.

``BM25Index`` lays out its whole corpus as the one-shard case of
``bm25_twotier_layout``; the sharded index lays out each rank's doc range
with the same function, so both run the same split (the budgeted threshold,
``term_row``, impact quantisation, low ranges and packed postings). The ops
that score the layout are in ``ops/bm25.py``.

The layout is the JAX package's (``index/sparse.py:313-502`` for one device,
``parallel/sharding.py::shard_bm25_twotier`` for many), computed with the
same numpy code. bf16 impacts are rounded from f32 to nearest even, as
``ml_dtypes`` rounds them for the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.core.device import DeviceLike

IMPACT_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}


def next_pow2(n: int, floor: int = 1) -> int:
    """The least power of two at or above ``max(n, floor)``: every capacity
    of the layouts is padded to one, so shapes change rarely."""
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def bm25_twotier_layout(
    csr: Dict[str, Any], n_shards: int, shard_cap: int, config,
    shards: Optional[Sequence[int]] = None, device: DeviceLike = "cpu",
) -> Dict[str, Any]:
    """Per-shard two-tier BM25 layout with global statistics.

    Each shard holds the postings of its doc range as (a) a dense
    ``[T, shard_cap]`` impact matrix of the high-df terms and (b) packed
    low-tier posting slices. Terms with df above the threshold become rows
    of the matrix; at most as many as fit ``impact_budget_bytes`` per shard
    (the threshold rises, and the low-tier ``beam`` with it, to fit). The
    dense-term set comes from GLOBAL document frequencies (the same
    ``term_row`` on every shard), and ``csr`` (``BM25Index.host_csr()``)
    carries global idf and avgdl, so shard scores equal single-device
    scores.

    Returns tensors on ``device`` with a leading dim, one per shard in
    ``shards`` (all by default), the replicated ``term_row`` (and its numpy
    array, ``term_row_host``), and the metadata ``beam``, ``nonneg``,
    ``pcap`` and ``tcap``, which are the same for every shard.
    """
    shards = range(n_shards) if shards is None else list(shards)
    dev = torch.device(device)
    tid_s = np.asarray(csr["tid"], dtype=np.int64)
    doc_s = np.asarray(csr["doc"], dtype=np.int64)
    w_s = np.asarray(csr["w"], dtype=np.float64)
    df = np.asarray(csr["df"], dtype=np.int64)
    vsize = df.shape[0]
    vcap = next_pow2(max(vsize, 1), floor=1024)
    n_post = tid_s.shape[0]

    thresh = config.dense_tier_threshold
    impact_dtype = IMPACT_DTYPES[config.impact_dtype]
    itemsize = torch.empty((), dtype=impact_dtype).element_size()
    max_rows = min(
        config.max_dense_tier_rows,
        max(config.impact_budget_bytes // max(shard_cap * itemsize, 1), 8),
    )
    if vsize and int((df > thresh).sum()) > max_rows:
        thresh = int(np.partition(df, -max_rows - 1)[-max_rows - 1])
    dense_terms = np.nonzero(df > thresh)[0]
    t_dense = dense_terms.shape[0]
    tcap = next_pow2(max(t_dense, 1), floor=8)
    term_row = np.full(vcap, -1, dtype=np.int32)
    term_row[dense_terms] = np.arange(t_dense, dtype=np.int32)
    is_dense_term = np.zeros(vcap, dtype=bool)
    is_dense_term[dense_terms] = True

    shard_of = (doc_s // shard_cap) if n_post else np.zeros(0, np.int64)
    counts = (
        np.bincount(shard_of, minlength=n_shards) if n_post else np.zeros(n_shards, np.int64)
    )
    pcap = next_pow2(int(counts.max()) if n_post else 1, floor=1024)

    n_out = len(shards)
    low_ranges = np.zeros((n_out, 2, vcap), dtype=np.int32)
    packed = np.zeros((n_out, 2, pcap), dtype=np.int32)
    impact_scale = np.ones((n_out, tcap), dtype=np.float32)
    impact = torch.zeros((n_out, tcap, shard_cap), dtype=impact_dtype, device=dev)

    for j, s in enumerate(shards):
        m = shard_of == s
        t_l = tid_s[m]
        d_l = doc_s[m] - s * shard_cap  # local row positions
        w_l = w_s[m]
        n_l = t_l.shape[0]
        # The global CSR order (term, then doc) survives the doc-range
        # filter, so the slices stay term-contiguous. Explicit (start, end)
        # ranges: a plain indptr cannot represent the emptied dense-tier
        # ranges, since end_i aliases start_{i+1}.
        cnt = np.bincount(t_l, minlength=vsize) if n_l else np.zeros(vsize, np.int64)
        iptr = np.zeros(vsize + 1, dtype=np.int64)
        np.cumsum(cnt, out=iptr[1:])
        low_start = np.full(vcap, n_l, dtype=np.int32)
        low_end = np.full(vcap, n_l, dtype=np.int32)
        low_start[:vsize] = iptr[:-1]
        low_end[:vsize] = iptr[1:]
        low_end[is_dense_term] = low_start[is_dense_term]
        low_ranges[j, 0] = low_start
        low_ranges[j, 1] = low_end

        # Packed low-tier postings: row 0 = doc, row 1 = f32 weight bits.
        packed[j, 0, :n_l] = d_l.astype(np.int32)
        packed[j, 1, :n_l] = w_l.astype(np.float32).view(np.int32)

        rows_of = term_row[t_l] if n_l else np.zeros(0, np.int32)
        mm = rows_of >= 0
        rows_m, docs_m, w_m = rows_of[mm], d_l[mm], w_l[mm]
        if config.impact_dtype == "int8":
            # Per-term symmetric quantization: row scale = max|w| / 127.
            row_max = np.zeros(tcap, dtype=np.float64)
            if rows_m.size:
                np.maximum.at(row_max, rows_m, np.abs(w_m))
            impact_scale[j] = np.maximum(row_max / 127.0, 1e-12).astype(np.float32)
            vals = torch.from_numpy(
                np.clip(np.rint(w_m / impact_scale[j][rows_m]), -127, 127).astype(np.int8))
        else:
            vals = torch.from_numpy(w_m.astype(np.float32)).to(impact_dtype)
        impact[j, torch.from_numpy(rows_m).to(dev), torch.from_numpy(docs_m).to(dev)] = (
            vals.to(dev))

    return {
        "low_ranges": torch.from_numpy(low_ranges).to(dev),
        "post_packed": torch.from_numpy(packed).to(dev),
        "term_row": torch.from_numpy(term_row).to(dev),
        "term_row_host": term_row,
        "impact": impact,
        "impact_scale": torch.from_numpy(impact_scale).to(dev),
        "beam": next_pow2(max(thresh, 1), floor=8),
        "nonneg": bool(w_s.min() >= 0) if n_post else True,
        "pcap": pcap,
        "tcap": tcap,
    }


def local_twotier(layout: Dict[str, Any], j: int) -> Dict[str, Any]:
    """Entry ``j`` of a ``bm25_twotier_layout``, without the leading shard
    dim; ``term_row`` and the metadata as there."""
    out = dict(layout)
    for name in ("low_ranges", "post_packed", "impact", "impact_scale"):
        out[name] = layout[name][j]
    return out
