#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases, each printing one line "phase <name> ok <seconds>":

  device  a CUDA card is required (the script fails without one);
  build   the CUDA kernel (nvcc) and the native tokenizer (g++), from the
          sources in the checkout, into build/rag_uq_tpu_torch/; prints the
          compiler's registers, spills and shared memory, and the counts of
          HGMMA (wgmma) and UTMALDG (TMA load) instructions in the library's
          SASS, and fails if either is zero;
  kernel  every kernel of the path against its plain PyTorch twin on the
          card: the edge cases of tests/test_pallas_topk.py, then at the
          main path's shapes B = 2048 and 1, k = 128 and MAX_K, a ragged
          query tile, a full index, all-negative scores past a partial last
          tile, ties across the corpus-chunk boundaries, and fp16 and f32
          corpora; timed with CUDA events beside its bound, the plain twin,
          torch.matmul + torch.topk (library_ms) and torch.matmul alone
          (library_matmul_ms), with the merge pass timed apart;
  slice   a 100k-passage index at bench.py's shape behind a QueryService
          (max_batch 2048, scatter-mode BM25, a pool7/maxnorm/binary router
          with seeded random weights) answering three 2048-query requests
          and one single query; the kernel's launch count must rise, the
          hits must be well formed and find their source passage far above
          chance, and the fused query rerun with the plain dense twin must
          agree under the tie rule.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
A watchdog dumps every thread's stack and exits non-zero if the run hangs.
Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement
from rag_uq_tpu_torch.cli.serve import QueryService
from rag_uq_tpu_torch.core.config import EmbedderConfig, router_recipe_v2
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.native import binding as native_binding
from rag_uq_tpu_torch.ops import cosine_topk as ck
from rag_uq_tpu_torch.retrieval import fused as fused_mod
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.text.tokenize import fnv1a_64

WATCHDOG_S = 840  # well inside the 1200 s a run may take
# bench.py's shape.
N_DOCS, DIM, VOCAB, DOC_LEN, BATCH, K, POOL = 100_000, 768, 30_000, 40, 2048, 10, 50
CAP = 131_072  # the dense index's capacity at 100k rows (pow2 growth)
# Published H100 SXM peaks (NVIDIA data sheet): bf16 dense tensor rate, HBM.
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
KERNEL_ATOL = 1e-3  # kernel vs plain twin: f32 sums of bf16 products, other order
F32_ATOL = 1e-5  # f32 corpus: f32 FMA products on both sides (no TF32), other order
FNV_PRIME = np.uint64(0x100000001B3)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name} ok {time.perf_counter() - t0:.3f}s", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_topk(kv, ki, pv, pi, what: str, atol: float = KERNEL_ATOL) -> float:
    """Kernel result vs plain twin: values within atol, same dead slots,
    indices equal or swapped only inside ties. Returns max |diff|."""
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    if not np.array_equal(np.isneginf(kv), np.isneginf(pv)) or not np.array_equal(ki < 0, pi < 0):
        raise AssertionError(f"{what}: dead slots differ")
    live = np.isfinite(pv)
    err = float(np.abs(kv[live] - pv[live]).max()) if live.any() else 0.0
    if err > atol:
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {atol}")
    agree = tie_aware_agreement(kv, ki, pv, pi, rtol=0.0, atol=atol)
    if agree["tie_aware_agreement"] != 1.0:
        raise AssertionError(f"{what}: indices disagree outside ties: {agree['violations'][:2]}")
    log(f"  {what}: max_abs_err {err:.3g}, index agreement raw "
        f"{agree['raw_idx_agreement']:.6f} tie-aware {agree['tie_aware_agreement']:.6f}")
    return err


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device {name} count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    return {"name": name, "smi": smi}


def phase_build() -> None:
    built = ck.build()
    log(f"  nvcc {built.path.name}: {built.seconds:.2f}s")
    for line in built.log.splitlines():
        if "Used" in line or "spill" in line or "smem" in line or "entry function" in line:
            log(f"  {line.strip()}")
    cuobjdump = Path(ck.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(built.path)],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"  SASS: HGMMA {counts['HGMMA']} UTMALDG {counts['UTMALDG']}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the library lacks wgmma or TMA loads: {counts}")
    t0 = time.perf_counter()
    native = native_binding.is_available()
    log(f"  tokenizer: {'native C++ (g++)' if native else 'Python fallback'} "
        f"{time.perf_counter() - t0:.2f}s")


def phase_kernel(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    def corpus(cap, dim, bsz):
        e = torch.randn((cap, dim), generator=gen, device=dev)
        q = torch.randn((bsz, dim), generator=gen, device=dev)
        return unit(e).bfloat16(), unit(q)

    def case(what, e, q, size, k, atol=KERNEL_ATOL):
        kv, ki = ck.cuda_cosine_topk(e, q, size, k)
        pv, pi = ck.cosine_topk_plain(e, q, size, k)
        return check_topk(kv, ki, pv, pi, what, atol), ki

    err = 0.0
    # The edge cases of tests/test_pallas_topk.py (feature widths are
    # multiples of 8, as the kernel requires).
    ties_e = torch.eye(8, device=dev).repeat(8, 1).bfloat16()
    cases = [
        ("partial", *corpus(512, 32, 6), 450, 8),
        ("size<k", *corpus(256, 16, 3), 5, 8),
        ("empty", *corpus(128, 16, 2), 0, 4),
        ("ties", ties_e, torch.eye(8, device=dev)[:3], 64, 6),
        ("bf16 full", *corpus(256, 32, 4), 256, 6),
    ]
    for what, e, q, size, k in cases:
        err = max(err, case(what, e, q, size, k)[0])

    # The main path's shapes: the whole index, a full batch and one query,
    # then the edge cases of the new kernel at the main capacity.
    emb, q = corpus(CAP, DIM, BATCH)
    for bsz in (BATCH, 1):
        err = max(err, case(f"B={bsz} cap={CAP} D={DIM} k={POOL}", emb, q[:bsz], N_DOCS, POOL)[0])
    for k in (128, ck.MAX_K):  # the two query tiles of kernel_config, and the pool limit
        cfg = ck.kernel_config(emb.dtype, k)
        err = max(err, case(f"k={k} (query tile {cfg.query_tile}, {cfg.stages} stages)",
                            emb, q, N_DOCS, k)[0])
    err = max(err, case("B=2047 (ragged query tile)", emb, q[:2047], N_DOCS, POOL)[0])
    err = max(err, case(f"size=cap={CAP} (full index)", emb, q, CAP, POOL)[0])
    # All scores negative: rows past `size` that the TMA fills with zeros
    # would score 0 and win if they were not masked.
    pos_e = unit(torch.randn((CAP, DIM), generator=gen, device=dev).abs()).bfloat16()
    neg_q = -unit(torch.randn((BATCH, DIM), generator=gen, device=dev).abs())
    err = max(err, case("all scores negative, size=100000", pos_e, neg_q, N_DOCS, POOL)[0])
    # Ties across chunk boundaries: query i finds four identical rows, two
    # on each side of the i-th boundary; the lowest rows must come first.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = ck.kernel_config(emb.dtype, POOL)
    n_chunks, chunk_rows = ck.chunking(BATCH, N_DOCS, cfg.query_tile, n_sm)
    tie_e = emb.clone()
    planted = []
    for i in range(n_chunks - 1):
        b = (i + 1) * chunk_rows
        tie_e[b - 2 : b + 2] = q[i].bfloat16()
        planted.append((i, list(range(b - 2, b + 2))))
    e_ties, ki = case(f"ties across {n_chunks - 1} chunk boundaries", tie_e, q, N_DOCS, POOL)
    err = max(err, e_ties)
    for i, rows in planted:
        if ki[i, :4].tolist() != rows:
            raise AssertionError(f"query {i}: tied rows {ki[i, :4].tolist()} != {rows}")
    log(f"  planted ties: rows {planted[0][1]} first for query 0, and so on")
    # fp16 and f32 corpora (f32: f32 FMA products, held to F32_ATOL).
    err = max(err, case("fp16 corpus", emb.half(), q, N_DOCS, POOL)[0])
    f32_err = case("f32 corpus", emb.float(), q, N_DOCS, POOL, F32_ATOL)[0]

    ms = cuda_ms(lambda: ck.cuda_cosine_topk(emb, q, N_DOCS, POOL), reps=20)
    plain_ms = cuda_ms(lambda: ck.cosine_topk_plain(emb, q, N_DOCS, POOL), reps=5)
    live = emb[:N_DOCS]
    q16 = q.bfloat16()

    def library():  # yardstick only: the port never calls this
        return torch.topk(torch.matmul(q16, live.T), POOL)

    def library_matmul():  # the products alone: yardstick only
        return torch.matmul(q16, live.T)

    library_ms = cuda_ms(library, reps=20)
    library_matmul_ms = cuda_ms(library_matmul, reps=20)
    # The merge pass alone, on the chunks' own sorted lists (each from the
    # plain twin over its chunk's rows); its result must equal the kernel's.
    part_v = torch.empty((BATCH, n_chunks, POOL), dtype=torch.float32, device=dev)
    part_i = torch.empty((BATCH, n_chunks, POOL), dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * chunk_rows, min((c + 1) * chunk_rows, N_DOCS)
        v, i = ck.cosine_topk_plain(emb[lo:hi], q, hi - lo, POOL)
        part_v[:, c], part_i[:, c] = v, torch.where(i >= 0, i + lo, i)
    mv, mi = ck.merge_pass(part_v, part_i, POOL)
    kv, ki = ck.cuda_cosine_topk(emb, q, N_DOCS, POOL)
    check_topk(mv, mi, kv, ki, "merge pass alone vs the kernel")
    merge_ms = cuda_ms(lambda: ck.merge_pass(part_v, part_i, POOL), reps=20)
    flops = 2.0 * BATCH * N_DOCS * DIM
    bytes_moved = N_DOCS * DIM * 2 + BATCH * DIM * 2 + BATCH * POOL * 8
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"  cosine_topk B={BATCH} live={N_DOCS} cap={CAP} D={DIM} k={POOL} "
        f"({n_chunks} chunks of {chunk_rows} rows, query tile {cfg.query_tile}, "
        f"{cfg.stages} stages): kernel {ms:.4f} ms (merge pass {merge_ms:.4f} ms, "
        f"{merge_ms / ms:.1%}), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
        f"library matmul {library_matmul_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_ms / ms:.1%} of it), kernel - matmul {ms - library_matmul_ms:.4f} ms")
    if ms > 100.0:
        raise AssertionError(f"one launch takes {ms:.1f} ms, over the 100 ms ceiling")
    return {
        "name": "cosine_topk", "route": "cuda",
        "source": "rag_uq_tpu_torch/csrc/cosine_topk.cu",
        "replaces": "rag_uq_tpu/ops/pallas_topk.py:157",
        "max_abs_err": err, "f32_max_abs_err": f32_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "library_matmul_ms": library_matmul_ms,
        "merge_ms": merge_ms,
    }


def fnv_features(doc_ids: np.ndarray, buckets: int) -> np.ndarray:
    """The NgramHashEmbedder feature ids of term-id passages, in bulk.

    A passage is the decimal term ids joined by spaces; its features are
    the unigram hashes in order, then the bigram hashes (FNV-1a 64 of
    "a\\x1fb"), exactly as NgramHashEmbedder._features lists them.
    """
    words = [str(t) for t in range(VOCAB)]
    uni = np.array([fnv1a_64(w) for w in words], dtype=np.uint64)
    width = max(len(w) for w in words)
    digits = np.zeros((VOCAB, width), dtype=np.uint64)
    lens = np.array([len(w) for w in words])
    for j in range(width):
        digits[:, j] = [ord(w[j]) if j < len(w) else 0 for w in words]
    a, b = doc_ids[:, :-1], doc_ids[:, 1:]
    with np.errstate(over="ignore"):
        h = (uni[a] ^ np.uint64(0x1F)) * FNV_PRIME
        for j in range(width):
            step = (h ^ digits[b, j]) * FNV_PRIME
            h = np.where(j < lens[b], step, h)
    feats = np.concatenate([uni[doc_ids], h], axis=1) % np.uint64(buckets)
    return feats.astype(np.int32)


def stage_times(retriever, router, queries) -> None:
    """Split one 2048-query request into host encoding and the fused query,
    and the fused query's BM25 pool (host clock, synchronized)."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    q_vecs, t_embed = timed(lambda: retriever.dense_index.embed_queries(queries))
    qterms, t_terms = timed(lambda: fused_mod.encode_for_fused(
        retriever.bm25_index, queries, active_compaction=True))
    state = retriever._fused_state()
    fused = fused_mod.make_fused_hybrid_query(
        router_module=router.module, k=K, pool=POOL,
        beam=retriever.bm25_index._device["beam"], sparse_mode="scatter")
    _, t_fused = timed(lambda: fused(state, q_vecs, qterms))
    _, t_bm25 = timed(lambda: fused_mod.bm25_ops.topk_lowscatter(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qterms["qtids_base"], POOL, beam=retriever.bm25_index._device["beam"],
        impact_scale=state["impact_scale"], active_rows=qterms["active_rows"],
        rows_compact=qterms["rows_compact"], low_blocks=state.get("low_blocks"),
        low_row=state.get("low_row")))
    log(f"  one 2048-query request: host query embedding {t_embed:.4f} s, host term "
        f"encoding {t_terms:.4f} s (active rows {qterms['active_rows'].shape[0]}), "
        f"fused query {t_fused:.4f} s, of which BM25 pool {t_bm25:.4f} s")


def phase_slice(seed: int, device_name: str) -> dict:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    t0 = time.perf_counter()
    doc_ids = rng.choice(VOCAB, size=(N_DOCS, DOC_LEN), p=p)
    texts = [" ".join(map(str, row)) for row in doc_ids]
    docs = [Document(str(i), t) for i, t in enumerate(texts)]
    log(f"  corpus: {N_DOCS} passages x {DOC_LEN} terms, Zipf over {VOCAB}: "
        f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    retriever = HybridRetriever(embedder_config=EmbedderConfig(dim=DIM), device="cuda")
    retriever.bm25_index.add_documents(docs)
    log(f"  bm25 host build ({'native' if retriever.bm25_index.uses_native else 'python'}): "
        f"{time.perf_counter() - t0:.2f}s, {retriever.bm25_index._n_postings} postings")

    # The dense side: the embedder's own vectors of every passage, computed
    # in bulk on the card from hashed features (not through the Python
    # hasher), then checked against embedder.encode on a sample.
    t0 = time.perf_counter()
    embedder = retriever.dense_index.embedder
    # Padded to the embedder's max_len, so the sums run as in encode().
    feats = np.zeros((N_DOCS, embedder.max_len), dtype=np.int32)
    n_feat = 2 * DOC_LEN - 1
    feats[:, :n_feat] = fnv_features(doc_ids, embedder.buckets)
    lengths = torch.full((4096,), n_feat, dtype=torch.int32)
    vecs = np.empty((N_DOCS, DIM), dtype=np.float32)
    for lo in range(0, N_DOCS, 4096):
        chunk = torch.from_numpy(feats[lo : lo + 4096])
        vecs[lo : lo + chunk.shape[0]] = (
            embedder.encode_device(chunk, lengths[: chunk.shape[0]]).cpu().numpy()
        )
    sample = rng.choice(N_DOCS, size=256, replace=False)
    direct = embedder.encode([texts[i] for i in sample])
    diff = np.abs(direct - vecs[sample])
    if diff.max() > 1e-2 or (diff == 0).mean() < 0.99:
        raise AssertionError(f"bulk passage vectors differ from embedder.encode: {diff.max()}")
    retriever.dense_index.add_precomputed(docs, vecs)
    log(f"  dense fill: {time.perf_counter() - t0:.2f}s, capacity {retriever.dense_index.capacity}")

    t0 = time.perf_counter()
    retriever._fused_state()
    torch.cuda.synchronize()
    dev_state = retriever.bm25_index._device
    log(f"  bm25 device sync: {time.perf_counter() - t0:.2f}s, impact "
        f"{tuple(dev_state['impact'].shape)} {dev_state['impact'].dtype}, beam {dev_state['beam']}")

    # Queries: 6 terms taken from a source passage (bench.py's recipe).
    def batch(n):
        src = rng.integers(0, N_DOCS, size=n)
        terms = doc_ids[src][:, :: DOC_LEN // 6][:, :6]
        return src, [" ".join(map(str, row)) for row in terms]

    requests = [batch(BATCH) for _ in range(3)] + [batch(1)]
    router = RetrievalRouter(router_recipe_v2(), seed=seed, device="cuda")
    service = QueryService(retriever, router=router, max_batch=BATCH, sparse_mode="scatter")
    try:
        ck.cuda_cosine_topk.launches = 0
        results, seconds = [], []
        for src, queries in requests:
            t0 = time.perf_counter()
            results.append(service.search(queries, k=K))
            seconds.append(time.perf_counter() - t0)
        launches = ck.cuda_cosine_topk.launches
    finally:
        service.close()
    if launches < len(requests):
        raise AssertionError(f"the kernel ran {launches} times for {len(requests)} requests")

    hits = found = 0
    for (src, _), res in zip(requests, results):
        if len(res) != len(src):
            raise AssertionError("a request lost queries")
        for s, row in zip(src, res):
            if len(row) != K:
                raise AssertionError(f"a query returned {len(row)} hits, not {K}")
            ids = [h["doc_id"] for h in row]
            if len(set(ids)) != K:
                raise AssertionError("duplicate hits")
            hits += 1
            found += str(s) in ids
    recall = found / hits
    if recall < 0.5:
        raise AssertionError(f"source-passage recall@{K} {recall:.3f} (chance {K / N_DOCS})")
    lat = sorted(seconds[:3])
    log(f"  served {hits} queries in {len(requests)} requests, kernel launches {launches}, "
        f"source recall@{K} {recall:.4f} (chance {K / N_DOCS:.0e})")
    log(f"  2048-query request latency s {[round(x, 4) for x in seconds[:3]]}, "
        f"median {lat[1]:.4f} s = {BATCH / lat[1]:.1f} queries/s; single query "
        f"{seconds[3]:.4f} s; on {device_name}")

    stage_times(retriever, router, requests[1][1])

    # The same fused query with the plain dense twin, on the same card.
    _, queries = requests[0]
    vals, pos = retriever.hybrid_search_batch(queries, top_k=K, router=router,
                                              sparse_mode="scatter")
    if vals.shape != (BATCH, K) or pos.shape != (BATCH, K):
        raise AssertionError(f"result shapes {vals.shape} {pos.shape}")
    dead = pos < 0
    if (dead[:, :-1] & ~dead[:, 1:]).any():
        raise AssertionError("-1 before a live hit")
    with mock.patch.object(fused_mod, "cuda_cosine_topk", ck.cosine_topk_plain):
        pvals, ppos = retriever.hybrid_search_batch(queries, top_k=K, router=router,
                                                    sparse_mode="scatter")
    agree = tie_aware_agreement(vals, pos, pvals, ppos, rtol=1e-4, atol=1e-5)
    if agree["tie_aware_agreement"] != 1.0:
        raise AssertionError(f"kernel path vs plain path: {agree['violations'][:2]}")
    log(f"  fused query kernel vs plain twin: raw {agree['raw_idx_agreement']:.6f}, "
        f"tie-aware {agree['tie_aware_agreement']:.6f}, max |score diff| "
        f"{agree['rankwise_max_abs_score_diff']:.3g}")
    return {"launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twins stay full f32
    with phase("device"):
        device = phase_device()
    with phase("build"):
        phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    with phase("kernel"):
        row = phase_kernel(gen)
    torch.cuda.empty_cache()
    with phase("slice"):
        row["launches"] = phase_slice(args.seed, device["name"])["launches"]
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
