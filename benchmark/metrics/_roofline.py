"""Least times of the layers the per-layer rooflines read, from shapes and inputs.

A least time is the larger of the operations over the peak rate and the
bytes over the peak bandwidth (``peaks.json``), counting each input byte
read once and each output byte written once, whatever an implementation
reads again.

- BM25 pool: the (doc, weight) postings of the batch's distinct query
  terms at 8 bytes a posting (a 4-byte doc id and a 4-byte weight), the
  query ids at 4 bytes, and the pool's outputs (a 4-byte score and a
  4-byte position a slot). No operations are counted: its work is the
  postings' additions, far under any compute bound.
- Dense pool: 2 * B * N * D operations at the bf16 tensor rate; the rows
  (2 bytes an element), the queries (2 bytes) and the outputs (8 bytes a
  slot).
- Fusion tail: the two pools read and the top-k written (8 bytes a slot),
  and the router's MLP over the union's columns (2 * columns * params).
"""

from __future__ import annotations

from typing import Dict, Iterable


def bm25_pool_bytes(df: Dict[int, int], terms: Iterable[int], n_query_ids: int, batch: int,
                    pool: int) -> float:
    postings = sum(df.get(int(t), 0) for t in set(terms))
    return 8.0 * postings + 4.0 * n_query_ids + 8.0 * batch * pool


def dense_pool_ops(batch: int, rows: int, dim: int) -> float:
    return 2.0 * batch * rows * dim


def dense_pool_bytes(batch: int, rows: int, dim: int, pool: int) -> float:
    return 2.0 * rows * dim + 2.0 * batch * dim + 8.0 * batch * pool


def tail_ops(batch: int, columns: int, router_params: int) -> float:
    return 2.0 * batch * columns * router_params


def tail_bytes(batch: int, pool: int, k: int) -> float:
    return 8.0 * batch * 2 * pool + 8.0 * batch * k


def least_s(ops: float, nbytes: float, peaks: Dict) -> float:
    return max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])

