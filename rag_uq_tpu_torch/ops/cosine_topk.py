"""Exact cosine top-k: the CUDA kernel ``csrc/cosine_topk.cu`` and its plain twin.

Counterpart of ``rag_uq_tpu/ops/pallas_topk.py::pallas_cosine_topk``, with the
same contract: for every query the k corpus rows with the largest
``q . e`` (bf16 operands, f32 accumulation), rows at or past ``size``
masked, ties to the lowest row index, ``-1`` where the value is ``-inf``
(fewer than k live rows, or the empty index). The Pallas constraints
``cap % block == 0`` and ``1 <= fan <= k`` do not apply here.

``cuda_cosine_topk`` takes the plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises. The kernel is built with
``nvcc`` at its first launch (``utils/build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from rag_uq_tpu_torch.ops.topk import cosine_topk_single
from rag_uq_tpu_torch.utils.build import Built, build_shared_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cosine_topk.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_K = 128
_ROW_TILE = 64  # corpus rows per score tile in the kernel (BN)
_QUERY_TILE = 64  # queries per block in the kernel (BQ)
_BLOCKS_PER_SM = 2  # the kernel's launch bound at k <= 128
_MAX_CHUNKS = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_built: Optional[Built] = None


def cosine_topk_plain(
    emb: torch.Tensor, queries: torch.Tensor, size: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin: ``ops/topk.py::cosine_topk_single``.

    It differs from the kernel only in the order of the f32 sums.
    """
    return cosine_topk_single(emb, queries, size, k)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def build() -> Built:
    """Compile the kernel (once per process; cached on disk by source hash)."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = build_shared_library(
                "rag_cosine_topk", [SOURCE], [nvcc_path(), *NVCC_FLAGS],
                timeout_s=600,
            )
            lib = ctypes.CDLL(str(built.path))
            c = ctypes
            lib.rag_cosine_topk.argtypes = [
                c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
                c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
                c.c_void_p, c.c_void_p,
            ]
            lib.rag_cosine_topk.restype = c.c_int
            _lib, _built = lib, built
        return _built


def _chunking(n_queries: int, live: int, device: torch.device) -> Tuple[int, int]:
    """(n_chunks, chunk_rows): enough blocks for one full wave on the card."""
    if live == 0:
        return 1, _ROW_TILE
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_qtiles = -(-n_queries // _QUERY_TILE)
    n_tiles = -(-live // _ROW_TILE)
    n_chunks = max(1, min(_BLOCKS_PER_SM * n_sm // n_qtiles, n_tiles, _MAX_CHUNKS))
    chunk_rows = -(-n_tiles // n_chunks) * _ROW_TILE
    return -(-live // chunk_rows), chunk_rows


def cuda_cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, size: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine (vals [B, k] f32, rows [B, k] int32; -1 = dead)."""
    cap = emb.shape[0]
    if not 1 <= k <= min(MAX_K, max(cap, 1)):
        raise ValueError(f"k={k} must be in [1, min({MAX_K}, capacity={cap})]")
    if emb.device.type == "cpu":
        return cosine_topk_plain(emb, queries, size, k)
    if emb.device.type != "cuda" or queries.device != emb.device:
        raise ValueError(
            f"cosine top-k needs both tensors on one CUDA device or the CPU; "
            f"got {emb.device} and {queries.device}"
        )
    if emb.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes a bf16 corpus, got {emb.dtype}")
    if emb.dim() != 2 or queries.dim() != 2 or queries.shape[1] != emb.shape[1]:
        raise ValueError(f"shapes {tuple(emb.shape)} and {tuple(queries.shape)}")
    n_q, dim = queries.shape
    if dim % 8 != 0:
        raise ValueError(f"feature width {dim} must be a multiple of 8")
    if not emb.is_contiguous() or emb.data_ptr() % 16 != 0:
        raise ValueError("the corpus matrix must be contiguous and 16-byte aligned")
    live = max(0, min(int(size), cap))
    vals = torch.empty((n_q, k), dtype=torch.float32, device=emb.device)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=emb.device)
    if n_q == 0:
        return vals, idx
    q = queries.to(torch.bfloat16).contiguous()
    n_chunks, chunk_rows = _chunking(n_q, live, emb.device)
    part_v = torch.empty((n_q, n_chunks, k), dtype=torch.float32, device=emb.device)
    part_i = torch.empty((n_q, n_chunks, k), dtype=torch.int32, device=emb.device)
    build()
    with torch.cuda.device(emb.device):
        rc = _lib.rag_cosine_topk(
            emb.data_ptr(), q.data_ptr(), n_q, dim, live, k, n_chunks,
            chunk_rows, part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), torch.cuda.current_stream(emb.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cosine top-k kernel launch failed: CUDA error {rc}")
    cuda_cosine_topk.launches += 1
    return vals, idx


cuda_cosine_topk.launches = 0
