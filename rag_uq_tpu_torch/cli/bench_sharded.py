"""Sharded retrieval bench: the counterpart of ``rag_uq_tpu/cli/bench_sharded.py``.

A synthetic corpus (1M passages by default; Zipf-ish ~20-token docs over a
50k vocabulary) goes into a ``ShardedHybridIndex`` over the process group's
ranks (``--devices``, the group's world size): data-parallel ingest, the
sharded layout, then the fused sharded query (per-shard two-tier BM25 and
dense pools, one all-gather of values and one of ids, the replicated tail).
It measures:

- the ingest and layout times, and the per-shard layout's sizes;
- fused-exact results against the three-searcher exact oracle
  (``search_batch_unfused``) on the first 16 queries, under the tie rule at
  the impact matrix's storage resolution (``tie_aware_agreement``);
- the steady time of a ``--batch`` query search on the host clock (after a
  first call that builds the kernels and warms cuBLAS), and ``qps``: the
  group's queries per second (every rank answers every query).

Run it alone for one rank on the card, or under ``torchrun`` for one rank a
card:  ``torchrun --nproc-per-node N -m rag_uq_tpu_torch.cli.bench_sharded
--devices N``. Rank 0 writes ``<outdir>/results.json`` with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def synthetic_corpus_texts(n_docs: int, seed: int = 0):
    """~20-token docs over a Zipf-ish 50k vocabulary, generated in bulk."""
    rng = np.random.default_rng(seed)
    vocab_size = 50_000
    # Zipf ranks: common terms get small ids (high df), tail terms high ids.
    u = rng.random(size=(n_docs, 20))
    ids = np.minimum((vocab_size ** u - 1).astype(np.int64), vocab_size - 1)
    logger.info("Generated %d docs of token ids", n_docs)
    return [" ".join(f"t{t}" for t in row) for row in ids]


def tie_aware_agreement(
    fv: np.ndarray, fp: np.ndarray, uv: np.ndarray, up: np.ndarray,
    rtol: float = 1e-5, atol: float = 1e-6,
) -> dict:
    """Compare top-k results (fv, fp) against a reference (uv, up).

    The contract: scores equal rank by rank within ``atol + rtol * |score|``,
    and every index disagreement confined to a maximal rank class of scores
    equal at that resolution. One addition to the JAX copy: a class that
    reaches rank k may continue past the cut, so its members are checked by
    score alone (either side's choice from a tie at the cut is a valid
    top-k).

    Returns raw positional agreement, rank-wise max |score diff|, tie-aware
    agreement, and per-query diagnostics for every disagreement that is not
    provably a tie.
    """
    n_q, k = fv.shape
    raw = float(np.mean(fp == up)) if fp.size else 1.0
    finite = np.isfinite(uv) & np.isfinite(fv)
    score_diff = float(np.max(np.abs(fv[finite] - uv[finite]))) if finite.any() else 0.0
    tie_ok = 0
    violations = []
    for q in range(n_q):
        if np.array_equal(fp[q], up[q]):
            tie_ok += 1
            continue
        if not np.allclose(fv[q], uv[q], rtol=rtol, atol=atol):
            violations.append({
                "query": int(q),
                "kind": "rankwise_score_mismatch",
                "fused_scores": fv[q].tolist(),
                "unfused_scores": uv[q].tolist(),
                "fused_pos": fp[q].tolist(),
                "unfused_pos": up[q].tolist(),
            })
            continue
        bad = []
        i = 0
        while i < k:
            j = i + 1
            while j < k and abs(uv[q, j] - uv[q, i]) <= (atol + rtol * abs(uv[q, i])):
                j += 1
            if j < k and set(map(int, fp[q, i:j])) != set(map(int, up[q, i:j])):
                bad.append({
                    "rank_class": [int(i), int(j)],
                    "score": float(uv[q, i]),
                    "fused_ids": fp[q, i:j].tolist(),
                    "unfused_ids": up[q, i:j].tolist(),
                })
            i = j
        if bad:
            violations.append({
                "query": int(q),
                "kind": "tie_class_membership_mismatch",
                "classes": bad,
                "fused_scores": fv[q].tolist(),
                "unfused_scores": uv[q].tolist(),
            })
        else:
            tie_ok += 1
    return {
        "raw_idx_agreement": raw,
        "rankwise_max_abs_score_diff": score_diff,
        "tie_aware_agreement": tie_ok / max(n_q, 1),
        "violations": violations,
    }


def run_bench(
    n_docs: int = 1_000_000,
    n_devices: Optional[int] = None,
    batch: int = 256,
    pool: int = 50,
    k: int = 10,
    impact_budget_mb: int = 128,
    impact_dtype: str = "bfloat16",
    outdir: str = "runs/sharded_torch",
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    import torch
    import torch.distributed as dist

    from rag_uq_tpu_torch.core.config import BM25Config, DenseIndexConfig
    from rag_uq_tpu_torch.core.device import card_info
    from rag_uq_tpu_torch.core.mesh import initialize_distributed, make_mesh, mesh_device, mesh_rank
    from rag_uq_tpu_torch.core.types import Document
    from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder
    from rag_uq_tpu_torch.parallel.sharded_index import ShardedHybridIndex

    initialize_distributed(device=device)
    mesh = make_mesh(n_devices, device)
    dev = mesh_device(mesh)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    out = Path(outdir)
    results: dict = {
        "n_docs": n_docs,
        "n_devices": mesh.size(),
        "backend": dev.type,
        "collective": dist.get_backend(mesh.get_group()),
        **card_info(dev),
        "batch": batch,
        "pool": pool,
        "k": k,
    }

    t0 = time.perf_counter()
    texts = synthetic_corpus_texts(n_docs, seed=seed)
    results["corpus_gen_s"] = round(time.perf_counter() - t0, 1)

    idx = ShardedHybridIndex(
        mesh,
        embedder=NgramHashEmbedder(dim=128, buckets=1 << 16, device=dev),
        bm25_config=BM25Config(
            initial_doc_capacity=1 << 20,
            initial_postings_capacity=1 << 25,
            impact_budget_bytes=impact_budget_mb << 20,
            impact_dtype=impact_dtype,
        ),
        dense_config=DenseIndexConfig(embedding_dim=128),
    )
    t0 = time.perf_counter()
    docs = [Document(str(i), t) for i, t in enumerate(texts)]
    results["doc_wrap_s"] = round(time.perf_counter() - t0, 1)
    t0 = clock()
    idx.add_documents(docs, batch_size=8192)
    results["ingest_s"] = round(clock() - t0, 1)
    logger.info("Ingested %d docs in %.0fs", len(idx), results["ingest_s"])

    t0 = clock()
    state = idx.sync()
    results["shard_layout_s"] = round(clock() - t0, 1)
    results["shard_cap"] = state["shard_cap"]
    tt = state["twotier"]
    results["twotier"] = {
        "tcap": tt["tcap"],
        "beam": tt["beam"],
        "pcap_per_shard": tt["pcap"],
        "impact_bytes_per_shard": int(tt["impact"].numel() * tt["impact"].element_size()),
    }
    logger.info("Shard layout: %s", results["twotier"])

    # Queries: a mix of common and tail terms.
    rng = np.random.default_rng(seed + 1)
    queries = [
        " ".join(f"t{int((50_000 ** rng.random()) - 1)}" for _ in range(5))
        for _ in range(batch)
    ]

    # Correctness at scale: fused exact against the unfused oracle (first 16
    # queries), under the tie rule at the impact storage resolution: the
    # fused high tier reads the stored impacts, the oracle f32 postings.
    t0 = clock()
    fv, fp = idx.search_batch(queries[:16], top_k=k, pool=pool, exact=True)
    results["fused_exact_first_batch_s"] = round(clock() - t0, 1)
    t0 = clock()
    uv, up = idx.search_batch_unfused(queries[:16], top_k=k, pool=pool)
    results["unfused_first_batch_s"] = round(clock() - t0, 1)
    rtol = {"bfloat16": 2.0 ** -8, "int8": 2.0 ** -6, "float32": 1e-6}[impact_dtype]
    results["score_resolution_rtol"] = rtol
    results["impact_dtype"] = str(tt["impact"].dtype).replace("torch.", "")
    cmp = tie_aware_agreement(fv, fp, uv, up, rtol=rtol)
    results["fused_vs_unfused_idx_agreement"] = cmp["raw_idx_agreement"]
    results["fused_vs_unfused_tie_aware_agreement"] = cmp["tie_aware_agreement"]
    results["rankwise_max_abs_score_diff"] = cmp["rankwise_max_abs_score_diff"]
    if cmp["violations"]:
        results["exactness_violations"] = cmp["violations"]
        logger.warning("fused/unfused disagreement outside ties at %d docs: %s",
                       n_docs, json.dumps(cmp["violations"])[:2000])

    # The steady search (the approximate path: exact top-k with the twotier
    # lsel truncation); the first call apart.
    t0 = clock()
    idx.search_batch(queries, top_k=k, pool=pool)
    results["approx_compile_plus_first_s"] = round(clock() - t0, 3)
    times = []
    for _ in range(3):
        t0 = clock()
        idx.search_batch(queries, top_k=k, pool=pool)
        times.append(clock() - t0)
    results["approx_steady_s_per_batch"] = float(np.mean(times))
    results["approx_steady_s_each"] = times
    results["qps"] = batch / float(np.mean(times))
    results["note"] = (
        f"{mesh.size()} rank(s) on {results['device_name']} "
        f"({results['power_limit']}), {results['collective']} collectives; host clock "
        "after a device synchronize; every rank answers every query."
    )

    if mesh_rank(mesh) == 0:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "results.json", "w") as f:
            json.dump(results, f, indent=2)
        logger.info("Results: %s", json.dumps(results, indent=2))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Sharded retrieval bench over the group's ranks")
    parser.add_argument("--docs", type=int, default=1_000_000)
    parser.add_argument("--devices", type=int, default=None,
                        help="shards: the group's world size (torchrun's ranks; one alone)")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--impact-budget-mb", type=int, default=128)
    parser.add_argument("--impact-dtype", default="bfloat16",
                        choices=["bfloat16", "float32", "int8"])
    parser.add_argument("--outdir", default="runs/sharded_torch")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch.distributed as dist

    try:
        run_bench(
            n_docs=args.docs, n_devices=args.devices, batch=args.batch,
            impact_budget_mb=args.impact_budget_mb, impact_dtype=args.impact_dtype,
            outdir=args.outdir, device=args.device,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
