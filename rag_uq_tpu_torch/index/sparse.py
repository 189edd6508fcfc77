"""BM25 sparse index: the counterpart of ``rag_uq_tpu/index/sparse.py::BM25Index``.

The host build (native C++ tokenizer, or the Python one when that does not
build), ``host_csr`` and the two-tier device layout of ``_sync_locked`` are
the JAX package's, computed with the same numpy code; the device arrays are
torch tensors on the index's device. The Okapi idf follows
``rank_bm25.BM25Okapi``: ln((N-df+0.5)/(df+0.5)), with strictly negative
values floored at epsilon * mean(idf).

With ``BM25Config.delta_sync_fraction > 0`` a search after live adds keeps
the base device state and scores the docs added since the base sync from a
small delta CSR (``build_delta_csr``), whose impacts use the base's frozen
idf and avgdl (bounded staleness, as in the JAX package). The queries
(``score_all_batch``, ``search_batch``, ``score_positions_batch``,
``search``) return numpy arrays, as the JAX index does. ``save``/``_load``
write and read the JAX package's format (JSON meta with the tokenizer
version, plus an ``.npz`` of the posting buffers), so either package loads
what the other saved.

Deviation: ``search_batch`` merges the base and delta pools with a stable
sort (earlier slot first on equal scores), where the JAX index uses an
unstable ``np.argsort`` (``index/sparse.py:665``) whose order among equal
scores is unspecified.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import BM25Config
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import DocStore, Document
from rag_uq_tpu_torch.ops import bm25 as bm25_ops
from rag_uq_tpu_torch.text.tokenize import TOKENIZER_VERSION, Vocab, tokenize

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


def build_delta_csr(
    tid: np.ndarray,
    doc: np.ndarray,
    tf: np.ndarray,
    doc_lens: Sequence[int],
    vsize: int,
    base: Dict[str, object],
    k1: float,
    b: float,
    n_delta_docs: int,
    vcap_min: int = 0,
) -> Dict[str, object]:
    """Delta CSR (numpy arrays) over postings added since a base snapshot
    (``index/sparse.py:41-106``).

    Impacts use the base's FROZEN idf/avgdl: known terms reuse the base idf;
    terms first seen in the delta get an idf from the frozen corpus size and
    their delta df, floored at the frozen epsilon like rank_bm25. ``base``
    needs keys docs, idf, eps, avgdl. ``doc`` holds global doc positions; the
    output ``post_doc`` is delta-local (doc - base docs).
    """
    tf = tf.astype(np.float64)
    order = np.argsort(tid, kind="stable")
    tid_s, doc_s, tf_s = tid[order], doc[order], tf[order]
    df_delta = np.bincount(tid_s, minlength=vsize).astype(np.int64)
    indptr = np.zeros(vsize + 1, dtype=np.int64)
    np.cumsum(df_delta, out=indptr[1:])

    idf = np.zeros(vsize, dtype=np.float64)
    base_idf = np.asarray(base["idf"])
    n_known = base_idf.shape[0]
    idf[:n_known] = base_idf
    new_terms = np.arange(n_known, vsize)
    if new_terms.size:
        dfn = np.maximum(df_delta[new_terms], 1)
        idf_new = np.log(base["docs"] - dfn + 0.5) - np.log(dfn + 0.5)
        idf[new_terms] = np.where(idf_new < 0, base["eps"], idf_new)

    dl = np.asarray(doc_lens, dtype=np.float64)[doc_s] if doc_s.size else np.zeros(0)
    denom = tf_s + k1 * (1.0 - b + b * dl / base["avgdl"])
    w_s = idf[tid_s] * tf_s * (k1 + 1.0) / np.maximum(denom, 1e-12)

    n_dp = tid_s.shape[0]
    pcap = _next_pow2(max(n_dp, 1), floor=256)
    vcap = max(vcap_min, _next_pow2(vsize, floor=1024))
    indptr_p = np.full(vcap + 1, n_dp, dtype=np.int32)
    indptr_p[: vsize + 1] = indptr.astype(np.int32)
    post_doc = np.zeros(pcap, dtype=np.int32)
    post_doc[:n_dp] = (doc_s - base["docs"]).astype(np.int32)  # delta-local
    post_w = np.zeros(pcap, dtype=np.float32)
    post_w[:n_dp] = w_s.astype(np.float32)
    return {
        "indptr": indptr_p,
        "post_doc": post_doc,
        "post_w": post_w,
        "n_docs_cap": int(_next_pow2(max(n_delta_docs, 1), floor=8)),
        "max_df": int(_next_pow2(int(df_delta.max()) if df_delta.size else 1, floor=8)),
        "base_docs": int(base["docs"]),
    }


class BM25Index:
    """Incremental BM25 index with device-side scoring."""

    def __init__(
        self,
        persist_path: Optional[str] = None,
        k1: float = 1.5,
        b: float = 0.75,
        config: Optional[BM25Config] = None,
        use_native: str = "auto",  # "auto" | "always" | "never"
        autosave: bool = True,
        device: DeviceLike = "cuda",
    ):
        # autosave=True persists after every add (the JAX index's default);
        # streaming builders set autosave=False and call save() once.
        self.config = config or BM25Config(k1=k1, b=b)
        self.persist_path = Path(persist_path) if persist_path else None
        self.autosave = autosave
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
        self._delta_device: Optional[Dict[str, object]] = None
        self._base: Optional[Dict[str, object]] = None
        # Bumped whenever device state is rebuilt: a cache-key component for
        # the retriever's fused-state cache.
        self.sync_generation = 0
        # Serializes index mutation against the lazy device sync.
        self._lock = threading.RLock()

        if self.persist_path and self.persist_path.exists():
            self._load()

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
            if self.persist_path and self.autosave:
                self._save()
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
        # Base snapshot for the main+delta sync: the frozen statistics score
        # later delta postings consistently with the unchanged base impacts.
        idf_full = np.zeros(vsize, dtype=np.float64)
        active = df > 0
        if n_post:
            idf_full[active] = np.log(n_docs - df[active] + 0.5) - np.log(df[active] + 0.5)
            avg_idf = idf_full[active].mean() if active.any() else 0.0
            idf_full[active & (idf_full < 0)] = self.config.idf_epsilon * avg_idf
        doc_len_all = np.asarray(self.doc_lens, dtype=np.float64)
        self._base = {
            "docs": n_docs,
            "postings": n_post,
            "idf": idf_full,
            # The new-term floor: epsilon times the mean of the floored idf,
            # as the JAX index takes it (``index/sparse.py:491``).
            "eps": (self.config.idf_epsilon * idf_full[active].mean())
            if n_post and active.any() else 0.0,
            "avgdl": doc_len_all.mean() if n_docs else 1.0,
        }
        self._delta_device = None
        self.sync_generation += 1
        logger.info(
            "Synced BM25 device index: %d docs, %d terms (%d dense-tier), "
            "%d postings", n_docs, vsize, t_dense, n_post,
        )
        return self._device

    # -- main+delta incremental sync ---------------------------------------------

    def _delta_fraction(self) -> float:
        base = self._base
        if base is None or base["docs"] == 0:
            return float("inf")
        return (len(self.store) - base["docs"]) / base["docs"]

    def _sync_incremental(self):
        """Return (base_device, delta_device_or_None).

        When ``delta_sync_fraction`` allows, keeps the base device state and
        (re)builds only a small CSR over the docs added since the base sync,
        with impacts from the base's frozen idf/avgdl; else a full sync.
        """
        with self._lock:
            return self._sync_incremental_locked()

    def _sync_incremental_locked(self):
        frac = self.config.delta_sync_fraction
        if (
            not self._dirty
            or frac <= 0.0
            or self._device is None
            or self._delta_fraction() > frac
        ):
            if self._dirty or self._device is None:
                self._sync_locked()
            return self._device, self._delta_device

        base = self._base
        lo, hi = base["postings"], self._n_postings
        n_delta_docs = len(self.store) - base["docs"]
        # The delta's vocabulary capacity is the larger of the base's (a
        # stable shape across small deltas) and the vocabulary's own (delta
        # docs can grow it past the base capacity).
        delta = build_delta_csr(
            self._tid[lo:hi], self._doc[lo:hi], self._tf[lo:hi],
            self.doc_lens, len(self.vocab), base, self.k1, self.b,
            n_delta_docs, vcap_min=self._device["indptr"].shape[0] - 1,
        )
        self._delta_device = {
            "indptr": self._to_device(delta["indptr"]),
            "post_doc": self._to_device(delta["post_doc"]),
            "post_w": self._to_device(delta["post_w"]),
            "n_docs_cap": delta["n_docs_cap"],
            "max_df": delta["max_df"],
            "base_docs": delta["base_docs"],
        }
        self._dirty = False
        self.sync_generation += 1
        logger.info(
            "Delta-synced BM25 index: +%d docs (+%d postings) over a %d-doc base",
            n_delta_docs, hi - lo, base["docs"],
        )
        return self._device, self._delta_device

    def _require_full_sync(self) -> Dict[str, object]:
        """Full device state covering every doc (collapses any live delta)."""
        with self._lock:
            if self._delta_device is not None:
                self._dirty = True
                self._delta_device = None
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

    def _qtids(self, queries: Sequence[str], qtids: Optional[np.ndarray]) -> torch.Tensor:
        ids = self.encode_queries(queries) if qtids is None else qtids
        return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(self.device)

    def score_all_batch(
        self, queries: Sequence[str], qtids: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Exhaustive BM25 scores [B, n_docs] (reference get_scores parity)."""
        dev = self._require_full_sync()
        scores = bm25_ops.score_all(
            dev["indptr"], dev["post_doc"], dev["post_w"],
            self._qtids(queries, qtids), dev["n_docs_cap"], dev["max_df"],
        )
        return scores[:, : len(self.store)].cpu().numpy()

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        exact: bool = True,
        approx: bool = False,
        qtids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k: (scores [B, k], doc positions [B, k], -1 = dead).

        ``exact=True`` takes the exhaustive scatter-add oracle (a full sync);
        ``exact=False`` the two-tier op (the same results up to the impact
        matrix's storage rounding and ties), which with
        ``delta_sync_fraction > 0`` may serve from a frozen base plus a small
        delta, merged with a stable sort. ``approx`` has no PyTorch
        counterpart (``lax.approx_max_k``): it only turns on ``lsel``.
        """
        qtids_np = self.encode_queries(queries) if qtids is None else qtids
        if exact:
            dev = self._require_full_sync()
            scores = bm25_ops.score_all(
                dev["indptr"], dev["post_doc"], dev["post_w"],
                self._qtids(queries, qtids_np), dev["n_docs_cap"], dev["max_df"],
            )
            vals, idx = bm25_ops.topk_from_scores(scores, top_k)
            return vals.cpu().numpy(), idx.cpu().numpy()

        dev, delta = self._sync_incremental()
        # Terms first seen after the base sync do not exist in the base
        # state; clamp them for the base lookup.
        base_vcap = dev["indptr"].shape[0] - 1
        qtids_base = np.where(qtids_np < base_vcap, qtids_np, -1)
        vals, idx = bm25_ops.topk_twotier(
            dev["low_ranges"], dev["post_packed"], dev["term_row"], dev["impact"],
            self._qtids(queries, qtids_base), top_k, beam=dev["beam"], approx=approx,
            lsel=self.config.lsel if approx else 0,
            impact_scale=dev["impact_scale"], nonneg=dev["nonneg"],
        )
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if delta is not None:
            dscores = bm25_ops.score_all(
                delta["indptr"], delta["post_doc"], delta["post_w"],
                self._qtids(queries, qtids_np), delta["n_docs_cap"], delta["max_df"],
            )
            dv, di = bm25_ops.topk_from_scores(dscores, min(top_k, delta["n_docs_cap"]))
            dv, di = dv.cpu().numpy(), di.cpu().numpy()
            di = np.where(di >= 0, di + delta["base_docs"], -1)
            cat_v = np.concatenate([vals, dv], axis=1)
            cat_i = np.concatenate([idx, di], axis=1)
            order = np.argsort(-cat_v, axis=1, kind="stable")[:, :top_k]
            vals = np.take_along_axis(cat_v, order, axis=1)
            idx = np.take_along_axis(cat_i, order, axis=1)
        dead = vals <= 0.0
        return np.where(dead, 0.0, vals).astype(np.float32), np.where(dead, -1, idx).astype(np.int32)

    def score_positions_batch(
        self,
        queries: Sequence[str],
        positions: np.ndarray,
        qtids: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Exact BM25 scores for given doc positions [B, P] (-1 padded)."""
        dev = self._require_full_sync()
        pos = torch.from_numpy(np.ascontiguousarray(positions, dtype=np.int32)).to(self.device)
        scores = bm25_ops.score_docs(
            dev["indptr"], dev["post_doc"], dev["post_w"], self._qtids(queries, qtids), pos
        )
        return scores.cpu().numpy()

    def search(self, query: str, top_k: int = 10) -> List[Tuple[str, float]]:
        """Single-query search; positive scores only."""
        if len(self.store) == 0:
            return []
        vals, idx = self.search_batch([query], top_k=min(top_k, len(self.store)))
        results = []
        for score, pos in zip(vals[0], idx[0]):
            if pos >= 0 and score > 0:
                results.append((self.store.ids[int(pos)], float(score)))
        return results

    def get_document(self, doc_id: str) -> Optional[Document]:
        return self.store.get(doc_id)

    # -- persistence ---------------------------------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        """Persist now (used with autosave=False streaming builds)."""
        if path is not None:
            self.persist_path = Path(path)
        self._save()

    def _save(self) -> None:
        """The JAX package's format: JSON meta at ``persist_path`` and the
        posting buffers in ``persist_path.with_suffix('.npz')``."""
        if self.persist_path is None:
            return
        self.persist_path.parent.mkdir(parents=True, exist_ok=True)
        n = self._n_postings
        np.savez_compressed(
            self.persist_path.with_suffix(".npz"),
            tid=self._tid[:n],
            doc=self._doc[:n],
            tf=self._tf[:n],
            doc_lens=np.asarray(self.doc_lens, dtype=np.int64),
        )
        meta = {
            "k1": self.k1,
            "b": self.b,
            "tokenizer": TOKENIZER_VERSION,
            "terms": [self.vocab.term_of(i) for i in range(len(self.vocab))],
            "docs": [
                {
                    "id": self.store.ids[i],
                    "text": self.store.texts[i],
                    "title": self.store.titles[i],
                    "metadata": self.store.metadatas[i],
                }
                for i in range(len(self.store))
            ],
        }
        with open(self.persist_path, "w") as f:
            json.dump(meta, f)
        logger.debug("Saved BM25 index to %s", self.persist_path)

    def _load(self) -> None:
        with open(self.persist_path) as f:
            meta = json.load(f)
        self.k1 = meta["k1"]
        self.b = meta["b"]
        saved_tok = meta.get("tokenizer", "v1-bare-split")
        if saved_tok != TOKENIZER_VERSION:
            # New queries and documents would tokenize differently from the
            # saved vocabulary: strict unless the config allows it.
            msg = (
                f"BM25 index {self.persist_path} was built with tokenizer "
                f"{saved_tok} (current: {TOKENIZER_VERSION}); rebuild the "
                "index for consistent tokenization"
            )
            if not self.config.allow_tokenizer_mismatch:
                raise ValueError(
                    msg + " (or set BM25Config.allow_tokenizer_mismatch=True "
                    "to load anyway)"
                )
            logger.warning("%s", msg)
        for term in meta["terms"]:
            self.vocab.add(term)
        if self._native is not None:
            self._native.seed_terms(meta["terms"])
        for d in meta["docs"]:
            self.store.append(
                Document(d["id"], d["text"], d.get("title"), d.get("metadata"))
            )
        with np.load(self.persist_path.with_suffix(".npz")) as arrays:
            n = arrays["tid"].shape[0]
            self._reserve(n)
            self._tid[:n] = arrays["tid"]
            self._doc[:n] = arrays["doc"]
            self._tf[:n] = arrays["tf"]
            self._n_postings = n
            self.doc_lens = arrays["doc_lens"].tolist()
        self._dirty = True
        logger.info("Loaded BM25 index with %d documents", len(self.store))
