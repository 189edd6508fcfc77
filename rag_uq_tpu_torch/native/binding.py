"""ctypes bindings for the native tokenizer/postings builder.

A copy of ``rag_uq_tpu/native/binding.py`` whose library is built with
``g++`` at first use into the port's build directory (``utils/build.py``),
not beside the source. If the build fails, callers fall back to the Python
tokenizer (``is_available()`` is False); the term ids are the same either way.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rag_uq_tpu_torch.utils.build import BuildError, build_shared_library

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "rag_native.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        built = build_shared_library(
            "rag_native", [_SRC],
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"], timeout_s=300,
        )
        return ctypes.CDLL(str(built.path))
    except (BuildError, OSError) as e:
        logger.warning("Native build failed (%s); using Python fallback", e)
        _build_failed = True
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                _declare(lib)
            _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.rag_ctx_new.restype = c.c_void_p
    lib.rag_ctx_free.argtypes = [c.c_void_p]
    lib.rag_vocab_size.argtypes = [c.c_void_p]
    lib.rag_vocab_size.restype = c.c_int64
    lib.rag_seed_terms.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64,
    ]
    lib.rag_add_documents.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64, c.c_int32,
    ]
    lib.rag_add_documents.restype = c.c_int64
    lib.rag_get_postings.argtypes = [c.c_void_p] + [
        c.POINTER(c.c_int32)
    ] * 3
    lib.rag_get_doc_lens.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.rag_new_terms_count.argtypes = [c.c_void_p]
    lib.rag_new_terms_count.restype = c.c_int64
    lib.rag_new_terms_bytes.argtypes = [c.c_void_p]
    lib.rag_new_terms_bytes.restype = c.c_int64
    lib.rag_get_new_terms.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64),
    ]
    lib.rag_encode_queries.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_int32), c.c_int32,
    ]


def is_available() -> bool:
    return _get_lib() is not None


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Lowercase (full-Unicode, Python-side) and concatenate texts."""
    encoded = [t.lower().encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeTokenizer:
    """C++ tokenizer + vocabulary, mirrored term-id order with Python."""

    def __init__(self):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ctx = lib.rag_ctx_new()

    def __del__(self):
        if getattr(self, "_ctx", None) and getattr(self, "_lib", None):
            self._lib.rag_ctx_free(self._ctx)
            self._ctx = None

    @property
    def vocab_size(self) -> int:
        return int(self._lib.rag_vocab_size(self._ctx))

    def seed_terms(self, terms: Sequence[str]) -> None:
        if not terms:
            return
        buf, offsets = _pack(list(terms))
        self._lib.rag_seed_terms(self._ctx, buf, _i64p(offsets), len(terms))

    def add_documents(
        self, texts: Sequence[str], doc_pos_start: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
        """Tokenize+count a batch.

        Returns (tids, docs, tfs, doc_lens, new_terms) where new_terms are
        the vocabulary additions in id order.
        """
        buf, offsets = _pack(texts)
        n_post = int(
            self._lib.rag_add_documents(
                self._ctx, buf, _i64p(offsets), len(texts), doc_pos_start
            )
        )
        tids = np.empty(n_post, dtype=np.int32)
        docs = np.empty(n_post, dtype=np.int32)
        tfs = np.empty(n_post, dtype=np.int32)
        self._lib.rag_get_postings(self._ctx, _i32p(tids), _i32p(docs), _i32p(tfs))
        doc_lens = np.empty(len(texts), dtype=np.int32)
        self._lib.rag_get_doc_lens(self._ctx, _i32p(doc_lens))

        n_new = int(self._lib.rag_new_terms_count(self._ctx))
        new_terms: List[str] = []
        if n_new:
            n_bytes = int(self._lib.rag_new_terms_bytes(self._ctx))
            term_buf = ctypes.create_string_buffer(max(n_bytes, 1))
            term_offsets = np.empty(n_new + 1, dtype=np.int64)
            self._lib.rag_get_new_terms(self._ctx, term_buf, _i64p(term_offsets))
            raw = term_buf.raw[:n_bytes]
            new_terms = [
                raw[term_offsets[i] : term_offsets[i + 1]].decode("utf-8")
                for i in range(n_new)
            ]
        return tids, docs, tfs, doc_lens, new_terms

    def encode_queries(self, queries: Sequence[str], max_terms: int) -> np.ndarray:
        """[B, max_terms] term ids against the existing vocab; -1 padded."""
        buf, offsets = _pack(queries)
        out = np.full((len(queries), max_terms), -1, dtype=np.int32)
        self._lib.rag_encode_queries(
            self._ctx, buf, _i64p(offsets), len(queries), _i32p(out), max_terms
        )
        return out
