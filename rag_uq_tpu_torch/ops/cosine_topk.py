"""Exact cosine top-k: the CUDA kernels ``csrc/cosine_topk.cu`` and
``csrc/cosine_topk_large.cu``, and their plain twin.

Counterpart of ``rag_uq_tpu/ops/pallas_topk.py::pallas_cosine_topk``, with the
same contract: for every query the k corpus rows with the largest
``q . e`` (operands in the corpus dtype, bf16, fp16 or f32; the queries are
cast to it; f32 accumulation), rows at or past ``size`` masked, ties to the
lowest row index, ``-1`` where the value is ``-inf`` (fewer than k live
rows, or the empty index). The Pallas constraints ``cap % block == 0`` and
``1 <= fan <= k`` do not apply here. k runs up to ``LARGE_MAX_K`` (8192, the
``block`` limit of the JAX ``cosine_topk``), capped by the capacity.

``cuda_cosine_topk`` takes the plain version only for tensors on the CPU. For
a CUDA tensor it launches a kernel or raises: up to ``MAX_K`` the heap kernel,
in the configuration ``kernel_config`` picks from the dtype and k; above it
the large-k kernels (a ``wgmma`` score pass into a ``[B_chunk, ld]`` buffer,
``ld = score_stride(live)``, then a per-query histogram select and radix
sort), with the queries chunked so the buffer stays within ``SCORE_BUDGET``
bytes. Each kernel is built with ``nvcc`` at its first launch
(``utils/build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch

from rag_uq_tpu_torch.ops.topk import cosine_topk_single
from rag_uq_tpu_torch.utils.build import Built, build_shared_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cosine_topk.cu"
SOURCE_LARGE = SOURCE.with_name("cosine_topk_large.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_K = 256  # the heap kernel's limit
LARGE_MAX_K = 8192  # the large-k kernels' limit
SCORE_BUDGET = 2 << 30  # bytes of the large-k path's score buffer
SMEM_LIMIT = 232_448  # dynamic shared memory a block can use on an H100
_ROW_TILE = 128  # corpus rows per score tile in the kernel (BN)
_BOX_BYTES = 128  # width of a TMA box: one 128-byte swizzle row
_MAX_STAGES = 6
_SCRATCH_BYTES = 128 * 8  # a consumer warp's candidate scratch
_MAX_CHUNKS = 64
_SCORE_ALIGN = 32  # floats: the large-k score rows start 128-byte aligned
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@dataclass(frozen=True)
class KernelConfig:
    """One launch configuration of the kernel (see the comment in the .cu)."""

    query_tile: int  # BQ: 128 (two consumer warpgroups) or 64 (one)
    stages: int  # depth of the TMA ring
    smem_bytes: int


def smem_bytes(query_tile: int, k: int, stages: int) -> int:
    """The kernel's shared memory, by the formula in ``csrc/cosine_topk.cu``."""
    return (
        1024
        + stages * (query_tile + _ROW_TILE) * _BOX_BYTES
        + query_tile * (k | 1) * 8
        + (query_tile // 16) * _SCRATCH_BYTES
        + stages * 16
    )


def kernel_config(dtype: torch.dtype, k: int) -> KernelConfig:
    """The configuration the wrapper launches for a corpus dtype and a k.

    Every box is 128 bytes wide whatever the dtype (64 bf16/fp16 or 32 f32
    columns), so only k and the query tile set the shared memory. BQ = 128
    where three stages fit beside the ``[BQ, k]`` lists (k <= 121), else 64;
    then as many stages as fit, at most 6. It refuses k > ``MAX_K``: the heap
    kernel's lists no longer fit, and ``cuda_cosine_topk`` takes such k to the
    large-k kernels, which need no configuration.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes a bf16, fp16 or f32 corpus, got {dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} is outside the kernel's limit [1, {MAX_K}]")
    for bq in (128, 64):
        fixed = smem_bytes(bq, k, 0)
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // ((bq + _ROW_TILE) * _BOX_BYTES + 16))
        if stages >= 3 or (bq == 64 and stages >= 2):
            return KernelConfig(bq, stages, smem_bytes(bq, k, stages))
    raise ValueError(f"k={k} does not fit the kernel's shared memory")


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_built: Optional[Built] = None
_large_lock = threading.Lock()
_large_lib: Optional[ctypes.CDLL] = None
_large_built: Optional[Built] = None


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


def load_library(name: str, flags: Tuple[str, ...]) -> Tuple[ctypes.CDLL, Built]:
    """Compile the kernel with ``flags`` (cached on disk by source and flags)
    and load it with its C functions typed."""
    built = build_shared_library(name, [SOURCE], [nvcc_path(), *flags], timeout_s=600)
    lib = ctypes.CDLL(str(built.path))
    c = ctypes
    lib.rag_cosine_topk.argtypes = [c.c_void_p, c.c_void_p, *[c.c_int] * 9, *[c.c_void_p] * 5]
    lib.rag_cosine_topk.restype = c.c_int
    lib.rag_cosine_topk_merge.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
    ]
    lib.rag_cosine_topk_merge.restype = c.c_int
    return lib, built


def build() -> Built:
    """Compile the kernel (once per process; cached on disk by source hash)."""
    global _lib, _built
    with _lock:
        if _lib is None:
            _lib, _built = load_library("rag_cosine_topk", NVCC_FLAGS)
        return _built


def build_large() -> Built:
    """Compile the large-k kernels (once per process; cached on disk)."""
    global _large_lib, _large_built
    with _large_lock:
        if _large_lib is None:
            built = build_shared_library(
                "rag_cosine_topk_large", [SOURCE_LARGE], [nvcc_path(), *NVCC_FLAGS],
                timeout_s=600,
            )
            lib = ctypes.CDLL(str(built.path))
            c = ctypes
            p, i = c.c_void_p, c.c_int
            lib.rag_cosine_topk_large.argtypes = [p, p, i, i, i, i, i, p, i, p, p, p, p]
            lib.rag_cosine_topk_large_scores.argtypes = [p, p, i, i, i, i, p, i, p, p]
            lib.rag_cosine_topk_large_select.argtypes = [p, i, p, i, i, i, p, p, p]
            for fn in (lib.rag_cosine_topk_large, lib.rag_cosine_topk_large_scores,
                       lib.rag_cosine_topk_large_select):
                fn.restype = c.c_int
            _large_lib, _large_built = lib, built
        return _large_built


def build_all() -> Tuple[Built, Built]:
    """Both libraries, one ``nvcc`` each, started together."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        heap, large = pool.submit(build), pool.submit(build_large)
        return heap.result(), large.result()


def chunking(n_queries: int, live: int, query_tile: int, n_sm: int) -> Tuple[int, int]:
    """(n_chunks, chunk_rows): about one block per SM, chunks in row tiles."""
    if live == 0:
        return 1, _ROW_TILE
    n_qtiles = -(-n_queries // query_tile)
    n_tiles = -(-live // _ROW_TILE)
    n_chunks = max(1, min(n_sm // n_qtiles, n_tiles, _MAX_CHUNKS))
    chunk_rows = -(-n_tiles // n_chunks) * _ROW_TILE
    return -(-live // chunk_rows), chunk_rows


def cuda_cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, size: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine (vals [B, k] f32, rows [B, k] int32; -1 = dead)."""
    cap = emb.shape[0]
    if not 1 <= k <= min(LARGE_MAX_K, max(cap, 1)):
        raise ValueError(
            f"k={k} must be in [1, min({LARGE_MAX_K}, capacity={cap})]"
        )
    if emb.device.type == "cpu":
        return cosine_topk_plain(emb, queries, size, k)
    if emb.device.type != "cuda" or queries.device != emb.device:
        raise ValueError(
            f"cosine top-k needs both tensors on one CUDA device or the CPU; "
            f"got {emb.device} and {queries.device}"
        )
    if emb.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes a bf16, fp16 or f32 corpus, got {emb.dtype}")
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
    q = queries.to(emb.dtype).contiguous()  # as pallas_topk.py casts them
    if q.data_ptr() % 16 != 0:
        q = q.clone()
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    if k > MAX_K:
        _large_topk(emb, q, live, k, vals, idx, stream)
        cuda_cosine_topk.large_launches += 1
    else:
        cfg = kernel_config(emb.dtype, k)
        n_sm = torch.cuda.get_device_properties(emb.device).multi_processor_count
        n_chunks, chunk_rows = chunking(n_q, live, cfg.query_tile, n_sm)
        part_v = torch.empty((n_q, n_chunks, k), dtype=torch.float32, device=emb.device)
        part_i = torch.empty((n_q, n_chunks, k), dtype=torch.int32, device=emb.device)
        build()
        with torch.cuda.device(emb.device):
            rc = _lib.rag_cosine_topk(
                emb.data_ptr(), q.data_ptr(), n_q, dim, live, k,
                _DTYPE_CODES[emb.dtype], cfg.query_tile, cfg.stages, n_chunks,
                chunk_rows, part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"cosine top-k kernel launch failed: CUDA error {rc}")
    cuda_cosine_topk.launches += 1
    return vals, idx


def score_stride(live: int) -> int:
    """Floats a row of the large-k score buffer: ``live`` rounded up to 32,
    so every row starts 128-byte aligned (at least 32)."""
    return max(_SCORE_ALIGN, -(-live // _SCORE_ALIGN) * _SCORE_ALIGN)


def large_chunk(n_queries: int, live: int) -> int:
    """Queries a chunk of the large-k path, so [chunk, score_stride(live)]
    f32 fits SCORE_BUDGET."""
    return max(1, min(n_queries, SCORE_BUDGET // (4 * score_stride(live))))


def _large_topk(
    emb: torch.Tensor, q: torch.Tensor, live: int, k: int,
    vals: torch.Tensor, idx: torch.Tensor, stream: int,
) -> None:
    """The large-k kernels over query chunks, into vals/idx."""
    n_q, dim = q.shape
    chunk, ld = large_chunk(n_q, live), score_stride(live)
    scores = torch.empty((chunk, ld), dtype=torch.float32, device=emb.device)
    stats = torch.empty((2, chunk), dtype=torch.int32, device=emb.device)
    build_large()
    with torch.cuda.device(emb.device):
        for lo in range(0, n_q, chunk):
            hi = min(lo + chunk, n_q)
            rc = _large_lib.rag_cosine_topk_large(
                emb.data_ptr(), q[lo:hi].data_ptr(), hi - lo, dim, live, k,
                _DTYPE_CODES[emb.dtype], scores.data_ptr(), ld, stats.data_ptr(),
                vals[lo:hi].data_ptr(), idx[lo:hi].data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"large-k cosine top-k launch failed: CUDA error {rc}")


cuda_cosine_topk.launches = 0  # every launch, either path
cuda_cosine_topk.large_launches = 0  # launches of the large-k path


def merge_pass(
    part_v: torch.Tensor, part_i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's second pass alone, over [B, n_chunks, k] sorted lists.

    For timing the pass apart (``chip_smoke.py``); the search path runs it
    inside ``cuda_cosine_topk`` and never calls this.
    """
    if (part_v.dtype != torch.float32 or part_i.dtype != torch.int32
            or part_v.shape != part_i.shape or part_v.dim() != 3 or part_v.shape[2] != k
            or part_v.device.type != "cuda" or part_i.device != part_v.device
            or not (part_v.is_contiguous() and part_i.is_contiguous())):
        raise ValueError("the merge pass takes contiguous [B, n_chunks, k] f32 and int32 "
                         "CUDA tensors")
    n_q, n_chunks, _ = part_v.shape
    vals = torch.empty((n_q, k), dtype=torch.float32, device=part_v.device)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=part_v.device)
    build()
    with torch.cuda.device(part_v.device):
        rc = _lib.rag_cosine_topk_merge(
            part_v.data_ptr(), part_i.data_ptr(), n_q, n_chunks, k, vals.data_ptr(),
            idx.data_ptr(), torch.cuda.current_stream(part_v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cosine top-k merge launch failed: CUDA error {rc}")
    return vals, idx


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous CUDA tensors on one device")


def large_score_pass(
    emb: torch.Tensor, queries: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large-k score pass alone, over every query at once: (scores
    [B, score_stride(live)] f32, whose columns past live are not written;
    stats [2, B], the ordered per-query max and min as int32 bits).

    For timing the pass apart (``chip_smoke.py``); the search path runs it
    inside ``cuda_cosine_topk`` and never calls this.
    """
    _check_cuda("the large-k score pass", emb, queries)
    if emb.dtype not in _DTYPE_CODES or queries.dtype != emb.dtype:
        raise TypeError("the score pass takes queries cast to a bf16, fp16 or f32 corpus")
    n_q, dim = queries.shape
    live = max(0, min(int(size), emb.shape[0]))
    ld = score_stride(live)
    scores = torch.empty((n_q, ld), dtype=torch.float32, device=emb.device)
    stats = torch.empty((2, n_q), dtype=torch.int32, device=emb.device)
    build_large()
    with torch.cuda.device(emb.device):
        rc = _large_lib.rag_cosine_topk_large_scores(
            emb.data_ptr(), queries.data_ptr(), n_q, dim, live, _DTYPE_CODES[emb.dtype],
            scores.data_ptr(), ld, stats.data_ptr(),
            torch.cuda.current_stream(emb.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"large-k score pass launch failed: CUDA error {rc}")
    return scores, stats


def large_select_pass(
    scores: torch.Tensor, stats: torch.Tensor, live: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large-k select alone, over what ``large_score_pass`` returned.

    For timing the pass apart (``chip_smoke.py``); never on the search path.
    """
    _check_cuda("the large-k select", scores, stats)
    n_q, ld = scores.shape
    if (scores.dtype != torch.float32 or stats.dtype != torch.int32
            or tuple(stats.shape) != (2, n_q) or ld != score_stride(live)):
        raise ValueError("the select takes the score pass's [B, ld] f32 and [2, B] int32")
    vals = torch.empty((n_q, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=scores.device)
    build_large()
    with torch.cuda.device(scores.device):
        rc = _large_lib.rag_cosine_topk_large_select(
            scores.data_ptr(), ld, stats.data_ptr(), n_q, live, k, vals.data_ptr(),
            idx.data_ptr(), torch.cuda.current_stream(scores.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"large-k select launch failed: CUDA error {rc}")
    return vals, idx

