"""Exact Okapi BM25 over a corpus of term ids, in float64.

Okapi as ``rank_bm25.BM25Okapi`` scores it: idf = ln(N - df + 0.5) -
ln(df + 0.5), a negative idf floored at ``idf_epsilon`` times the mean idf;
weight = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl)); a
query's score sums the weights of its tokens, a repeated token counting
again. Storage precision as the deployment states it: the weights of terms
in the impact matrix (the ``max_dense_tier_rows`` highest document
frequencies above ``dense_tier_threshold``, fewer when the matrix would
pass ``impact_budget_bytes``) are stored in ``impact_dtype``, every other
weight in float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

STORAGE = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn, "float32": torch.float32}


def _next_pow2(n: int, floor: int) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


class BM25:
    """``docs`` is a list of term-id sequences (one per passage)."""

    def __init__(self, docs: Sequence[np.ndarray], n_terms: int, cfg: Dict, device,
                 impact_dtype: str = None):
        self.device = device
        self.n_docs = len(docs)
        lens = np.array([len(d) for d in docs], dtype=np.int64)
        flat = np.concatenate([np.asarray(d, dtype=np.int64) for d in docs]) if len(docs) else \
            np.zeros(0, np.int64)
        doc_of = np.repeat(np.arange(self.n_docs, dtype=np.int64), lens)
        keys = torch.from_numpy(doc_of * n_terms + flat).to(device)
        uniq, tf = torch.unique(keys, return_counts=True)
        doc = uniq // n_terms
        term = uniq % n_terms
        df = torch.bincount(term, minlength=n_terms).double()
        n = float(self.n_docs)
        active = df > 0
        idf = torch.zeros(n_terms, dtype=torch.float64, device=device)
        idf[active] = torch.log(n - df[active] + 0.5) - torch.log(df[active] + 0.5)
        eps = cfg["idf_epsilon"] * idf[active].mean()
        idf = torch.where(active & (idf < 0), eps, idf)
        dl = torch.from_numpy(lens).double().to(device)
        avgdl = dl.mean()
        k1, b = cfg["k1"], cfg["b"]
        tf = tf.double()
        w = idf[term] * tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl[doc] / avgdl))
        # Which terms the impact matrix holds, and their storage.
        ncap = _next_pow2(self.n_docs, 1024)
        dtype = STORAGE[impact_dtype or cfg["impact_dtype"]]
        itemsize = torch.empty((), dtype=STORAGE[cfg["impact_dtype"]]).element_size()
        max_rows = min(cfg["max_dense_tier_rows"],
                       max(cfg["impact_budget_bytes"] // max(ncap * itemsize, 1), 8))
        df_np = df[active].cpu().numpy()
        thresh = cfg["dense_tier_threshold"]
        if int((df_np > thresh).sum()) > max_rows:
            thresh = int(np.partition(df_np, -max_rows - 1)[-max_rows - 1])
        in_matrix = (df > thresh)[term]
        self.df = df
        self.matrix_terms = int((df > thresh).sum())
        stored = torch.where(in_matrix, _round(w, dtype), w.float().double())
        order = torch.argsort(term, stable=True)
        self.term_sorted = term[order]
        self.doc_sorted = doc[order]
        self.w_sorted = stored[order]
        self.indptr = torch.zeros(n_terms + 1, dtype=torch.int64, device=device)
        self.indptr[1:] = torch.cumsum(torch.bincount(term, minlength=n_terms), 0)

    def scores(self, queries: List[List[int]]) -> torch.Tensor:
        """[Q, N] float64 scores; a query is its term ids (-1 = unknown)."""
        q_n = len(queries)
        out = torch.zeros((q_n, self.n_docs), dtype=torch.float64, device=self.device)
        terms = sorted({t for q in queries for t in q if t >= 0})
        if not terms:
            return out
        col = {t: i for i, t in enumerate(terms)}
        counts = torch.zeros((q_n, len(terms)), dtype=torch.float64)
        for i, q in enumerate(queries):
            for t in q:
                if t >= 0:
                    counts[i, col[t]] += 1
        t_ix = torch.tensor(terms, device=self.device)
        starts, ends = self.indptr[t_ix], self.indptr[t_ix + 1]
        lens = ends - starts
        row = torch.repeat_interleave(torch.arange(len(terms), device=self.device), lens)
        offs = torch.arange(int(lens.sum()), device=self.device) - torch.repeat_interleave(
            torch.cumsum(lens, 0) - lens, lens)
        src = torch.repeat_interleave(starts, lens) + offs
        sub = torch.zeros((len(terms), self.n_docs), dtype=torch.float64, device=self.device)
        sub[row, self.doc_sorted[src]] = self.w_sorted[src]
        return counts.to(self.device) @ sub


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round values to ``dtype`` and widen them to float64; fp8 goes through
    float32 and saturates at its largest finite value."""
    if dtype == torch.float8_e4m3fn:
        return x.float().clamp(-448.0, 448.0).to(dtype).double()
    return x.to(dtype).double()


def storage_round(x: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """``x`` rounded to a storage dtype and widened to float64."""
    return _round(x, STORAGE[dtype_name])
