"""Per-stage device time of the fused hybrid query at ``bench.py``'s shape:
the counterpart of ``rag_uq_tpu/cli/profile_fused.py``.

It builds the bench corpus (100k passages of 40 Zipf term ids over 30k
terms, ``np.random.default_rng(0)`` as ``bench.py`` draws it), a BM25 index
on the device and random unit bf16 passage vectors (D = 768, capacity
rounded up to 16,384-row blocks), and times each stage of the fused query
as its own call, plus the full query at several batch sizes:

- the full query in scatter mode (plain term ids, and the serving path's
  active-row compaction with the padded low-tier blocks) and in two-tier
  mode;
- the dense pool (the hand-written top-k kernel on a card) and the dense
  product alone;
- the BM25 pools whole (scatter with and without compaction, two-tier), and
  the served scatter pool's parts, through the functions of
  ``ops/bm25.py`` that ``topk_lowscatter`` runs: the active-row gather of
  the impact matrix, the high-tier product (``high_tier``: the one-hot and
  the product), the low-tier block gather (``block_postings``) with its
  scatter-add, and the top-k over the ``[B, N]`` totals;
- the union merge, router gate and final top-k (``fuse_pools_select``).

On a card each time is CUDA events around ``reps`` launches after
``warmup`` launches, divided by ``reps``; on the CPU (``--device cpu``, for
the tests) it is the host clock. Stage calls are separate, so the stages
need not add up to the full query; the full query is the ground truth.
``fused_breakdown.json`` has the JAX file's keys, the stage names of the
port's operations (the port's top-k is exact where the TPU's was
``approx_max_k``) and the device it ran on.

Run: ``python3 -m rag_uq_tpu_torch.cli.profile_fused [--outdir
runs/profile_torch] [--reps 5] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.core.config import BM25Config
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.index.sparse import BM25Index
from rag_uq_tpu_torch.ops import bm25 as bm25_ops
from rag_uq_tpu_torch.ops.cosine_topk import cuda_cosine_topk
from rag_uq_tpu_torch.ops.topk import cosine_topk_single, stable_topk
from rag_uq_tpu_torch.retrieval.fused import (
    build_index_state,
    encode_for_fused,
    fuse_pools_select,
    make_fused_hybrid_query,
)
from rag_uq_tpu_torch.router.model import RetrievalRouter

logger = logging.getLogger(__name__)


def time_program(fn: Callable[[], object], device: torch.device, reps: int = 5,
                 warmup: int = 2) -> float:
    """Mean seconds of one ``fn()``: CUDA events around ``reps`` calls on a
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


class DenseRows:
    """The two attributes ``build_index_state`` reads of a DenseIndex: the
    device matrix and the live row count."""

    def __init__(self, emb: torch.Tensor, size: int):
        self._emb, self._size = emb, size

    def __len__(self) -> int:
        return self._size


def run_profile(
    n_docs: int = 100_000,
    dim: int = 768,
    vocab: int = 30_000,
    doc_len: int = 40,
    batch: int = 2048,
    pool: int = 50,
    k: int = 10,
    block: int = 16_384,
    outdir: str = "runs/profile_torch",
    reps: int = 5,
    impact_dtype: Optional[str] = None,
    batch_sizes: Sequence[int] = (256, 512, 1024, 2048),
    device: DeviceLike = "cuda",
) -> Dict:
    dev = resolve_device(device)

    # -- bench.py's corpus ------------------------------------------------------------
    rng = np.random.default_rng(0)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    docs = rng.choice(vocab, size=(n_docs, doc_len), p=probs)
    texts = [" ".join(map(str, row)) for row in docs]
    config = BM25Config(impact_dtype=impact_dtype) if impact_dtype else None
    bm25 = BM25Index(config=config, device=dev)
    bm25.add_documents([Document(str(i), t) for i, t in enumerate(texts)])

    cap = ((n_docs + block - 1) // block) * block
    gen = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((cap, dim), generator=gen, device=dev)
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    state = build_index_state(DenseRows(emb, n_docs), bm25)
    synced = bm25._device
    beam, nonneg = synced["beam"], synced["nonneg"]
    tcap, ncap = state["impact"].shape
    results: Dict = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_docs": n_docs, "batch": batch, "pool": pool, "cap": cap, "tcap": tcap,
        "beam": beam, "impact_dtype": str(state["impact"].dtype).replace("torch.", ""),
        "reps": reps,
    }
    if "low_blocks" in state:
        results["low_blocks_shape"] = list(state["low_blocks"].shape)

    def make_batch(seed: int, bsz: int, compact: bool):
        r = np.random.default_rng(seed)
        src = r.integers(0, n_docs, size=bsz)
        g = torch.Generator(device=dev).manual_seed(seed)
        q = emb[torch.from_numpy(src).to(dev)].float()
        q = q + torch.randn((bsz, dim), generator=g, device=dev) * 0.7
        q = q / q.norm(dim=1, keepdim=True)
        terms = docs[src][:, :: doc_len // 6][:, :6]
        qtexts = [" ".join(map(str, row)) for row in terms]
        return q, encode_for_fused(bm25, qtexts, active_compaction=compact)

    q, qterms = make_batch(12345, batch, compact=True)
    qtids = qterms["qtids_base"]
    plain_terms = {key: qterms[key] for key in ("qtids", "qtids_base")}
    results["active_rows_bucket"] = int(qterms["active_rows"].shape[0])
    router = RetrievalRouter(device=dev)
    stages: Dict[str, float] = {}

    def stage(name: str, fn: Callable[[], object]) -> None:
        stages[name] = time_program(fn, dev, reps=reps)

    def fused_query(sparse_mode: str):
        return make_fused_hybrid_query(
            router_module=router.module, k=k, pool=pool, block=block, beam=beam,
            nonneg=nonneg, dense_mode="single_approx", sparse_mode=sparse_mode)

    scatter, twotier = fused_query("scatter"), fused_query("twotier")
    # -- the full query -----------------------------------------------------------------
    stage("full_fused_scatter", lambda: scatter(state, q, plain_terms))
    stage("full_fused_scatter_compact_blocks", lambda: scatter(state, q, qterms))
    stage("full_fused_twotier", lambda: twotier(state, q, qterms))

    # -- the dense pool -----------------------------------------------------------------
    stage("dense_matmul_only", lambda: torch.matmul(q.to(emb.dtype), emb.T))
    dense_pool = cuda_cosine_topk if dev.type == "cuda" else cosine_topk_single
    stage("dense_pool", lambda: dense_pool(emb, q, n_docs, pool))

    # -- the BM25 pools -----------------------------------------------------------------
    low = dict(low_ranges=state["low_ranges"], post_packed=state["post_packed"],
               term_row=state["term_row"], impact=state["impact"])
    stage("bm25_scatter_full", lambda: bm25_ops.topk_lowscatter(
        **low, qtids=qtids, k=pool, beam=beam, impact_scale=state["impact_scale"]))
    stage("bm25_scatter_full_compact_blocks", lambda: bm25_ops.topk_lowscatter(
        **low, qtids=qtids, k=pool, beam=beam, impact_scale=state["impact_scale"],
        active_rows=qterms["active_rows"], rows_compact=qterms["rows_compact"],
        low_blocks=state.get("low_blocks"), low_row=state.get("low_row")))
    stage("bm25_twotier_full", lambda: bm25_ops.topk_twotier(
        **low, qtids=qtids, k=pool, beam=beam, impact_scale=state["impact_scale"],
        nonneg=nonneg))

    # The served scatter pool's parts, through the pieces ops/bm25.py's
    # topk_lowscatter runs.
    impact, act = state["impact"], qterms["active_rows"].long()
    stage("bm25_active_row_gather", lambda: impact[act])
    sub_impact, sub_scale = impact[act], state["impact_scale"][act]
    total = bm25_ops.scatter_totals(batch, ncap, dev)
    stage("bm25_high_tier_matmul_compact", lambda: bm25_ops.high_tier(
        sub_impact, qtids, state["term_row"], sub_scale, rows_compact=qterms["rows_compact"],
        out=total[:, :ncap]))
    if "low_blocks" in state:
        def low_scatter() -> torch.Tensor:
            docs_, w = bm25_ops.block_postings(state["low_blocks"], state["low_row"], qtids)
            return total.scatter_add_(1, docs_.long(), w)

        stage("bm25_low_blocks_plus_scatter", low_scatter)
    stage("bm25_topk_over_BN", lambda: stable_topk(total[:, :ncap], pool))

    # -- the union merge, router gate and final top-k ---------------------------------------
    r = torch.Generator(device=dev).manual_seed(2)
    bvals = torch.rand((batch, pool), generator=r, device=dev)
    dvals = torch.rand((batch, pool), generator=r, device=dev)
    bidx = torch.randint(0, n_docs, (batch, pool), generator=r, device=dev)
    didx = torch.randint(0, n_docs, (batch, pool), generator=r, device=dev)
    stage("union_merge_router_topk_tail", lambda: fuse_pools_select(
        bvals, bidx, dvals, didx, k, router_module=router.module))

    # -- the full query by batch size -------------------------------------------------------
    scaling = {}
    for bsz in batch_sizes:
        qb, qtb = make_batch(777, bsz, compact=True)
        scaling[str(bsz)] = round(time_program(
            lambda: scatter(state, qb, qtb), dev, reps=reps) * 1000, 4)
    results["full_fused_ms_by_batch"] = scaling
    results["stages_ms"] = {name: round(s * 1000, 4) for name, s in stages.items()}
    results["qps_at_batch"] = round(batch / stages["full_fused_scatter"], 1)
    results["qps_at_batch_compact_blocks"] = round(
        batch / stages["full_fused_scatter_compact_blocks"], 1)

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "fused_breakdown.json", "w") as f:
        json.dump(results, f, indent=2)
    logger.info("breakdown: %s", json.dumps(results, indent=2))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Fused hybrid query per-stage profile")
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--outdir", default="runs/profile_torch")
    parser.add_argument("--impact-dtype", default=None,
                        help="override BM25Config.impact_dtype (e.g. int8)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(run_profile(
        batch=args.batch, reps=args.reps, outdir=args.outdir,
        impact_dtype=args.impact_dtype, device=args.device,
    ), indent=2))


if __name__ == "__main__":
    main()
