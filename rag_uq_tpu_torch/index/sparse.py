"""BM25 sparse index: the counterpart of ``rag_uq_tpu/index/sparse.py::BM25Index``.

The host build (native C++ tokenizer, or the Python one when that does not
build), ``host_csr`` and the two-tier device layout of ``_sync_locked`` are
the JAX package's, computed with the same numpy code; the device arrays are
torch tensors on the index's device. The Okapi idf follows
``rank_bm25.BM25Okapi``: ln((N-df+0.5)/(df+0.5)), with strictly negative
values floored at epsilon * mean(idf).

Persistence (``save``/``load``) and the main+delta incremental sync
(``build_delta_csr``, ``_sync_incremental``) wait for a later slice: a
config with ``delta_sync_fraction > 0`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import BM25Config
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document
from rag_uq_tpu_torch.text.tokenize import Vocab, tokenize

logger = logging.getLogger(__name__)

_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}


def _next_pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


class BM25Index:
    """Incremental BM25 index with device-side scoring."""

    def __init__(
        self,
        config: Optional[BM25Config] = None,
        use_native: str = "auto",  # "auto" | "always" | "never"
        device: DeviceLike = "cuda",
    ):
        self.config = config or BM25Config()
        if self.config.delta_sync_fraction > 0:
            raise NotImplementedError(
                "the main+delta incremental sync (delta_sync_fraction > 0) "
                "is not ported yet; it waits for the next slice"
            )
        if self.config.impact_dtype not in _TORCH_DTYPES:
            raise ValueError(f"unknown impact_dtype {self.config.impact_dtype!r}")
        self.device = resolve_device(device)
        self.k1 = self.config.k1
        self.b = self.config.b

        self.vocab = Vocab()
        self.store = DocStore()
        self.doc_lens: List[int] = []

        # Native C++ tokenize/count path; the Python vocabulary stays
        # mirrored in id order so both paths interoperate.
        self._native = None
        if use_native in ("auto", "always"):
            from rag_uq_tpu_torch.native import NativeTokenizer, is_available

            if is_available():
                self._native = NativeTokenizer()
            elif use_native == "always":
                raise RuntimeError("native tokenizer unavailable")

        # Flat append-only posting buffers (host).
        cap = self.config.initial_postings_capacity
        self._tid = np.zeros(cap, dtype=np.int32)
        self._doc = np.zeros(cap, dtype=np.int32)
        self._tf = np.zeros(cap, dtype=np.int32)
        self._n_postings = 0

        self._dirty = True
        self._device: Optional[Dict[str, object]] = None
        # Bumped whenever device state is rebuilt: a cache-key component for
        # the retriever's fused-state cache.
        self.sync_generation = 0
        # Serializes index mutation against the lazy device sync.
        self._lock = threading.RLock()

    @property
    def uses_native(self) -> bool:
        return self._native is not None

    # -- build ----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.store)

    def _reserve(self, extra: int) -> None:
        need = self._n_postings + extra
        if need <= self._tid.shape[0]:
            return
        new_cap = _next_pow2(need)
        for name in ("_tid", "_doc", "_tf"):
            buf = getattr(self, name)
            grown = np.zeros(new_cap, dtype=buf.dtype)
            grown[: self._n_postings] = buf[: self._n_postings]
            setattr(self, name, grown)

    def add_documents(self, documents: Sequence[Document]) -> int:
        """Add new documents (dedup by id). Returns number added."""
        with self._lock:
            # Dedup against the store AND within the batch (first wins).
            seen = {}
            for doc in documents:
                if doc.id not in self.store and doc.id not in seen:
                    seen[doc.id] = doc
            fresh = list(seen.values())
            if not fresh:
                return 0
            if self._native is not None:
                self._add_documents_native(fresh)
            else:
                self._add_documents_python(fresh)
            self._dirty = True
            logger.info(
                "Added %d documents to BM25 index. Total: %d",
                len(fresh), len(self),
            )
            return len(fresh)

    def _append_postings(self, tids, docs, tfs) -> None:
        n = len(tids)
        self._reserve(n)
        s = self._n_postings
        self._tid[s : s + n] = tids
        self._doc[s : s + n] = docs
        self._tf[s : s + n] = tfs
        self._n_postings += n

    def _add_documents_python(self, fresh: Sequence[Document]) -> None:
        new_tids: List[int] = []
        new_docs: List[int] = []
        new_tfs: List[int] = []
        for doc in fresh:
            pos = self.store.append(doc)
            toks = tokenize(doc.text)
            self.doc_lens.append(len(toks))
            counts: Dict[int, int] = {}
            for tok in toks:
                tid = self.vocab.add(tok)
                counts[tid] = counts.get(tid, 0) + 1
            for tid, tf in counts.items():
                new_tids.append(tid)
                new_docs.append(pos)
                new_tfs.append(tf)
        self._append_postings(new_tids, new_docs, new_tfs)

    def _add_documents_native(self, fresh: Sequence[Document]) -> None:
        pos_start = len(self.store)
        tids, docs, tfs, doc_lens, new_terms = self._native.add_documents(
            [doc.text for doc in fresh], pos_start
        )
        for doc in fresh:
            self.store.append(doc)
        self.doc_lens.extend(int(x) for x in doc_lens)
        # Mirror the native vocabulary additions (same id order).
        for term in new_terms:
            self.vocab.add(term)
        if len(self.vocab) != self._native.vocab_size:
            raise RuntimeError("python/native vocabulary desync")
        self._append_postings(tids, docs, tfs)

    def host_csr(self) -> Dict[str, object]:
        """Host-side CSR with precomputed impacts (``index/sparse.py:261``).

        Returns {indptr (int64, [V+1]), tid, doc, w, df, max_df, n_docs}.
        """
        n_docs = len(self.store)
        n_post = self._n_postings
        vsize = len(self.vocab)
        tid = self._tid[:n_post]
        doc = self._doc[:n_post]
        tf = self._tf[:n_post].astype(np.float64)

        # CSR by term, docs ascending within each term (stable sort over
        # buffers that were appended in ascending doc order).
        order = np.argsort(tid, kind="stable")
        tid_s, doc_s, tf_s = tid[order], doc[order], tf[order]
        df = np.bincount(tid_s, minlength=vsize).astype(np.int64)
        indptr = np.zeros(vsize + 1, dtype=np.int64)
        np.cumsum(df, out=indptr[1:])

        # Okapi idf with rank_bm25's epsilon floor.
        idf = np.zeros(vsize, dtype=np.float64)
        active = df > 0
        idf[active] = np.log(n_docs - df[active] + 0.5) - np.log(df[active] + 0.5)
        if active.any():
            avg_idf = idf[active].mean()
            eps = self.config.idf_epsilon * avg_idf
            idf[active & (idf < 0)] = eps

        # Precompute per-posting impacts.
        doc_len = np.asarray(self.doc_lens, dtype=np.float64)
        avgdl = doc_len.mean() if n_docs else 1.0
        dl = doc_len[doc_s] if n_docs else np.zeros(0)
        denom = tf_s + self.k1 * (1.0 - self.b + self.b * dl / avgdl)
        w_s = idf[tid_s] * tf_s * (self.k1 + 1.0) / np.maximum(denom, 1e-12)
        return {
            "indptr": indptr,
            "tid": tid_s,
            "doc": doc_s,
            "w": w_s,
            "df": df,
            "max_df": int(_next_pow2(int(df.max()) if vsize else 1, floor=8)),
            "n_docs": n_docs,
        }

    def _sync(self) -> Dict[str, object]:
        """(Re)build device CSR arrays from host buffers. Lazy: only if dirty."""
        with self._lock:
            return self._sync_locked()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync_locked(self) -> Dict[str, object]:
        """The two-tier device layout of ``index/sparse.py:313-502``."""
        if self._device is not None and not self._dirty:
            return self._device

        csr = self.host_csr()
        n_docs = len(self.store)
        n_post = self._n_postings
        vsize = len(self.vocab)
        indptr, doc_s, w_s, df = csr["indptr"], csr["doc"], csr["w"], csr["df"]
        tid_s = csr["tid"]

        pcap = _next_pow2(max(n_post, 1), floor=1024)
        vcap = _next_pow2(max(vsize, 1), floor=1024)
        ncap = _next_pow2(max(n_docs, 1), floor=1024)

        post_doc = np.zeros(pcap, dtype=np.int32)
        post_doc[:n_post] = doc_s
        post_w = np.zeros(pcap, dtype=np.float32)
        post_w[:n_post] = w_s
        indptr_p = np.full(vcap + 1, n_post, dtype=np.int32)
        indptr_p[: vsize + 1] = indptr.astype(np.int32)

        # Two-tier split: terms with df > threshold become rows of a dense
        # [T, Ncap] impact matrix; the others are fully covered by posting
        # slices of length `threshold`. At most max_rows terms go dense (the
        # threshold rises, and the low-tier beam with it, to fit the budget).
        thresh = self.config.dense_tier_threshold
        impact_dtype = _TORCH_DTYPES[self.config.impact_dtype]
        itemsize = torch.empty((), dtype=impact_dtype).element_size()
        max_rows = min(
            self.config.max_dense_tier_rows,
            max(self.config.impact_budget_bytes // max(ncap * itemsize, 1), 8),
        )
        if vsize and int((df > thresh).sum()) > max_rows:
            thresh = int(np.partition(df, -max_rows - 1)[-max_rows - 1])
        dense_terms = np.nonzero(df > thresh)[0]
        t_dense = dense_terms.shape[0]
        tcap = _next_pow2(max(t_dense, 1), floor=8)
        term_row = np.full(vcap, -1, dtype=np.int32)
        term_row[dense_terms] = np.arange(t_dense, dtype=np.int32)

        impact_scale = np.ones(tcap, dtype=np.float32)
        impact = torch.zeros((tcap, ncap), dtype=impact_dtype, device=self.device)
        if n_post:
            rows_of_post = term_row[tid_s]
            m = rows_of_post >= 0
            rows_m, docs_m, w_m = rows_of_post[m], doc_s[m], w_s[m]
            if self.config.impact_dtype == "int8":
                # Per-term symmetric quantization: row scale = max|w| / 127.
                row_max = np.zeros(tcap, dtype=np.float64)
                np.maximum.at(row_max, rows_m, np.abs(w_m))
                impact_scale = np.maximum(row_max / 127.0, 1e-12).astype(np.float32)
                vals = torch.from_numpy(
                    np.clip(np.rint(w_m / impact_scale[rows_m]), -127, 127)
                    .astype(np.int8)
                )
            else:
                # f64 -> f32 -> storage dtype, as ml_dtypes rounds for the TPU.
                vals = torch.from_numpy(w_m).to(impact_dtype)
            impact[self._to_device(rows_m).long(), self._to_device(docs_m).long()] = (
                vals.to(self.device)
            )

        # Explicit (start, end) ranges: a plain indptr cannot represent the
        # emptied dense-tier ranges since end_i aliases start_{i+1}.
        low_start = indptr_p[:-1].copy()
        low_end = indptr_p[1:].copy()
        is_dense_term = np.zeros(vcap, dtype=bool)
        is_dense_term[dense_terms] = True
        low_end[is_dense_term] = low_start[is_dense_term]
        low_ranges = np.stack([low_start, low_end]).astype(np.int32)

        # Packed low-tier postings: row 0 = doc, row 1 = f32 weight bits.
        packed = np.zeros((2, pcap), dtype=np.int32)
        packed[0, :n_post] = doc_s.astype(np.int32)
        packed[1, :n_post] = w_s.astype(np.float32).view(np.int32)

        # Padded per-term low-tier blocks [lcap, 2, beam], built within the
        # byte budget: a query's low tier is then one row gather. Padding
        # entries point at doc ncap (the totals' spare column); row lcap-1 is
        # all padding, and unknown/dense-tier terms map there.
        beam_cap = int(_next_pow2(thresh, floor=8))
        low_mask = (~is_dense_term[:vsize]) & (df > 0) if vsize else (
            np.zeros(0, dtype=bool)
        )
        low_terms = np.nonzero(low_mask)[0]
        n_low = int(low_terms.shape[0])
        lcap = _next_pow2(n_low + 1, floor=8)
        block_bytes = lcap * 2 * beam_cap * 4
        low_blocks = low_row = None
        if block_bytes <= self.config.low_block_budget_bytes:
            low_blocks = np.zeros((lcap, 2, beam_cap), dtype=np.int32)
            low_blocks[:, 0, :] = ncap
            low_row = np.full(vcap, lcap - 1, dtype=np.int32)
            low_row[low_terms] = np.arange(n_low, dtype=np.int32)
            if n_low:
                starts = indptr_p[low_terms].astype(np.int64)
                lens = (indptr_p[low_terms + 1] - indptr_p[low_terms]).astype(
                    np.int64
                )
                off = np.arange(beam_cap, dtype=np.int64)
                idx = np.clip(starts[:, None] + off[None, :], 0,
                              max(n_post - 1, 0))
                ok = off[None, :] < lens[:, None]
                low_blocks[:n_low, 0] = np.where(ok, doc_s[idx], ncap)
                low_blocks[:n_low, 1] = np.where(
                    ok, w_s[idx].astype(np.float32).view(np.int32), 0
                )

        self._term_row_host = term_row
        self._device = {
            "indptr": self._to_device(indptr_p),
            "post_doc": self._to_device(post_doc),
            "post_w": self._to_device(post_w),
            "low_ranges": self._to_device(low_ranges),
            "post_packed": self._to_device(packed),
            "term_row": self._to_device(term_row),
            "impact": impact,
            "impact_scale": self._to_device(impact_scale),
            "beam": beam_cap,
            "nonneg": bool(w_s.min() >= 0) if n_post else True,
            "max_df": int(_next_pow2(int(df.max()) if vsize else 1, floor=8)),
            "n_docs_cap": int(ncap),
        }
        if low_blocks is not None:
            self._device["low_blocks"] = self._to_device(low_blocks)
            self._device["low_row"] = self._to_device(low_row)
        self._dirty = False
        self.sync_generation += 1
        logger.info(
            "Synced BM25 device index: %d docs, %d terms (%d dense-tier), "
            "%d postings", n_docs, vsize, t_dense, n_post,
        )
        return self._device

    def _require_full_sync(self) -> Dict[str, object]:
        """Full device state covering every doc."""
        with self._lock:
            return self._sync_locked()

    # -- queries ---------------------------------------------------------------

    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        """Tokenize + vocab-encode queries into a padded [B, Lq] id batch."""
        if self._native is not None:
            out = self._native.encode_queries(queries, self.config.max_query_terms)
            # Trim trailing all-padding columns to the next power-of-2 bucket
            # (a trailing -1 slot is padding or an unknown term; both add 0).
            live_cols = np.nonzero((out != -1).any(axis=0))[0]
            longest = int(live_cols[-1]) + 1 if live_cols.size else 1
            lq = min(_next_pow2(longest, floor=8), self.config.max_query_terms)
            return np.ascontiguousarray(out[:, :lq])
        token_lists = [tokenize(q) for q in queries]
        max_terms = self.config.max_query_terms
        longest = max((len(t) for t in token_lists), default=1)
        lq = min(_next_pow2(max(longest, 1), floor=8), max_terms)
        out = np.full((len(queries), lq), -1, dtype=np.int32)
        for i, toks in enumerate(token_lists):
            ids = self.vocab.encode(toks[:lq])
            out[i, : len(ids)] = ids
        return out
