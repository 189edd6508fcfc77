#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases, each printing one line "phase <name> ok <seconds>":

  device   a CUDA card is required (the script fails without one);
  build    both CUDA libraries (the heap kernel csrc/cosine_topk.cu and the
           large-k kernels csrc/cosine_topk_large.cu, one nvcc each, started
           together) and the native tokenizer (g++), from the sources in the
           checkout, into build/rag_uq_tpu_torch/; prints the compiler's
           registers, spills and shared memory, and the counts of HGMMA
           (wgmma) and UTMALDG (TMA load) instructions in each library's
           SASS, and fails if either is zero in either;
  kernel   the heap kernel against its plain PyTorch twin on the card: the
           edge cases of tests/test_pallas_topk.py, then at the main path's
           shapes B = 2048 and 1, k = 128 and MAX_K, a ragged query tile, a
           full index, all-negative scores past a partial last tile, ties
           across the corpus-chunk boundaries, fp16 and f32 corpora, and
           D = 256 (the trained encoder's width, which the answer phase
           serves) at the main batch and index;
           timed with CUDA events beside its bound, the plain twin,
           torch.matmul + torch.topk (library_ms) and torch.matmul alone
           (library_matmul_ms), with the merge pass timed apart;
  large_k  the k > MAX_K path against the plain twin: k = 257, 1000 and 8192
           at the main shape (the score pass and the select also timed
           apart, and the select held bit for bit to a stable sort of the
           score pass's own scores), a ragged query count, fewer live rows
           than k, k = live, live = k + 1, live not a multiple of 32 (the
           padded score stride), ties across row-tile, compaction-step and
           query-chunk boundaries, every corpus row identical (the select's
           refine path), two values a row (ties of the k-th value in one
           bin), fp16 and f32 corpora, and D = 100 (stored padded to 104)
           and D = 104 through DenseIndex; each case timed with CUDA events
           beside torch.matmul + torch.topk, and each main-shape k beside
           its bound and the plain twin;
  slice    a 100k-passage index at bench.py's shape behind a QueryService
           (max_batch 2048, scatter-mode BM25, a pool7/maxnorm/binary router
           with seeded random weights) answering three 2048-query requests
           and one single query; the hits must be well formed and find their
           source passage far above chance, and the fused query rerun with
           the plain dense twin must agree under the tie rule;
  twotier  the same index behind QueryService(sparse_mode="twotier"), three
           2048-query requests: the same recall gate, the two-tier BM25 pool
           against the scatter pool and the served hits against the scatter
           service's under the tie rule, and the stage times of both pools;
  ingest   2,000 new passages through QueryService.ingest with
           delta_sync_fraction = 0.05: no full resync (the base device state
           and generation), queries built from the new passages find them,
           the delta BM25 pool equals a frozen-statistics oracle, and the
           delta answers overlap a full resync's;
  persist  the index saved to a temporary directory in the JAX package's
           format and reloaded onto the card answers the same queries
           identically (the fused query, and DenseIndex.search_batch at
           k = 1000, the large-k path); serve_http on 127.0.0.1:0 answers
           /healthz, /search, /ingest and /answer through urllib;
  answer   the JAX server's default configuration from the checkpoints in
           the checkout: the demo run's encoder, router and TinyLM
           (models/tiny_lm_r5), and cli/serve.py main's two default paths
           (loaded, not served); the 5,000 demo passages embedded on the card
           (64 held to the same module on the CPU, cosine >= 0.999) into a
           HybridRetriever behind a QueryService with the router; the heap
           kernel against its plain twin at the answer path's shapes (B = 500,
           k = 10 and B = 1, k = 50 over the 5,000 live D = 256 rows, before
           the path's launch counts are zeroed); dense-only
           recall@10 of gold_doc_ids over 500 questions >= 0.7; 32 questions
           through serve_http's /answer (concat policy) and 8 per_passage,
           well formed, exact match within 0.1 of the fixture
           tests/data/torch_answer_fixture.json's; the fixture's 32 prompts
           decoded greedily, at least 28 answers equal to the JAX package's;
           MC confidence for 16 questions x 10 samples in one generate call,
           twice with one seed (same answers); the demo calibration set's
           conformal threshold and p-values against numpy; generate and
           /answer round-trip times;
  train    the training path on the demo run's data: the heap kernel
           against its plain twin at the router data path's shape (B = 512,
           k = 50 over the 5,000 live D = 256 rows); cli/train_router.py's
           prepare_training_data over nq.jsonl rows [1500, 3000) (90/10)
           and train_router at the demo's pool7 configuration (hidden 64,
           2 layers, dropout 0.1) with TrainConfig's defaults: the loss
           falls, validation hit@1 >= 0.80, final_router.msgpack reloads to
           the same weights; a step under torch.profiler; cli/
           train_encoder.py's train_encoder from a random init at the demo
           encoder's configuration, 200 steps at batch 256: the mean loss of
           the last 20 steps below the first 20's, held-out recall@10 (the
           heap kernel) above the untrained encoder's, the checkpoint
           reloads; TinyLMTrainer warm started from models/tiny_lm_r5 at its
           recipe (batch 64 x 1,024 bytes): the training forward against the
           KV-cached decode at the last prompt position of 16 rows (mean
           |logit diff| < 0.1, 90% same argmax), step 1 (learning rate 0)
           moves nothing, 30 steps at 2e-4 lower one fixed batch's loss,
           step time, tokens/s, TFLOP/s, peak memory and a profiled step's
           idle share; fit_qa, the exported sampler answering 4 prompts,
           the checkpoint reloading; and cli/train_lm.py's train_extractor
           at a small size.

Each of the five serving paths and the two kernel paths of the train phase
runs with the kernel's launch counts set to 0 just before it and fails if
the dense kernel was not launched in it (the persist path also if the
large-k kernels were not). Then every number the train phase recorded, one
"train <key> <value>" line each, one JSON line {"kernels": [...]}, a row for
the heap kernel and one for the large-k kernels, and, last,
{"ok": true, "device": ...}.
A watchdog dumps every thread's stack and exits non-zero if the run hangs.
Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import itertools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from rag_uq_tpu_torch.cli import serve as serve_mod
from rag_uq_tpu_torch.cli import train_encoder as train_encoder_cli
from rag_uq_tpu_torch.cli import train_lm as train_lm_cli
from rag_uq_tpu_torch.cli import train_router as train_router_cli
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement
from rag_uq_tpu_torch.cli.evaluate import build_qa_prompt
from rag_uq_tpu_torch.cli.serve import QueryService, serve_http
from rag_uq_tpu_torch.core.config import (
    BM25Config, DenseIndexConfig, EmbedderConfig, RouterConfig, TrainConfig, router_recipe_v2,
)
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.embed.hash_embed import Sha256Embedder
from rag_uq_tpu_torch.embed.train import EncoderTrainConfig, load_encoder_checkpoint
from rag_uq_tpu_torch.eval.metrics import exact_match
from rag_uq_tpu_torch.index.dense import DenseIndex
from rag_uq_tpu_torch.llm.tiny_lm import TinyLM, TinyLMConfig
from rag_uq_tpu_torch.llm.train import (
    LMTrainConfig, TinyLMTrainer, encode_qa_examples, load_lm_checkpoint,
)
from rag_uq_tpu_torch.native import binding as native_binding
from rag_uq_tpu_torch.ops import cosine_topk as ck
from rag_uq_tpu_torch.retrieval import fused as fused_mod
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.train import RouterTrainer, load_router_checkpoint
from rag_uq_tpu_torch.text.tokenize import fnv1a_64
from rag_uq_tpu_torch.uq.conformal import ConformalRAG, conformal_p_value_device
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

WATCHDOG_S = 840  # well inside the 1200 s a run may take
# bench.py's shape.
N_DOCS, DIM, VOCAB, DOC_LEN, BATCH, K, POOL = 100_000, 768, 30_000, 40, 2048, 10, 50
CAP = 131_072  # the dense index's capacity at 100k rows (pow2 growth)
# Published H100 SXM peaks (NVIDIA data sheet): bf16 dense tensor rate, HBM.
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
DELTA_FRACTION, N_INGEST = 0.05, 2000  # live ingest: 2% of the base, under the fraction
LARGE_KS = (257, 1000, 8192)
KERNEL_ATOL = 1e-3  # kernel vs plain twin: f32 sums of bf16 products, other order
F32_ATOL = 1e-5  # f32 corpus: f32 FMA products on both sides (no TF32), other order
FNV_PRIME = np.uint64(0x100000001B3)
# The answer phase: the demo run's checkpoints and data, and main's defaults.
ENCODER_DIM = 256
RUN = Path("runs/demo_full_r4")
DEMO_ENCODER, DEMO_ROUTER = RUN / "encoder/encoder.msgpack", RUN / "router/best_router.msgpack"
DEMO_LM = Path("models/tiny_lm_r5/tiny_lm.msgpack")
FIXTURE = Path("tests/data/torch_answer_fixture.json")
N_RECALL, N_ANSWER, N_PER_PASSAGE, N_MC, MC_SAMPLES = 500, 32, 8, 16, 10
MIN_DENSE_RECALL, EM_SLACK, MIN_GREEDY_SAME = 0.7, 0.1, 28
# The train phase: run_pipeline's fit tail of nq.jsonl for the router (after
# its 500 calibration and 1,000 test rows), its pool width and batch; the
# encoder's steps; TinyLM's recipe (models/tiny_lm_r5) and the bf16 bound of
# tests/test_torch_tiny_lm.py on the training forward against the decode.
ROUTER_ROWS, ROUTER_POOL, ROUTER_DATA_BATCH, MIN_ROUTER_HIT = (1500, 3000), 20, 512, 0.80
ENCODER_STEPS = 200
LM_BATCH, LM_SEQ, LM_LR, LM_STEPS, LM_CHECK_ROWS, LM_LOGIT_BOUND = 64, 1024, 2e-4, 30, 16, 0.1


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


def check_topk(kv, ki, pv, pi, what: str, atol: float = KERNEL_ATOL,
               plain_rows=None) -> float:
    """Kernel result vs plain twin: values within atol, same dead slots,
    indices equal or swapped only inside ties. Returns max |diff|.

    Ties are tie_aware_agreement's rank classes, anchored at each class's
    first value. Where plain_rows (query ids -> the plain product's score
    rows) is given, a query those classes flag is judged row by row
    instead: at every rank where the indices differ, the kernel's row must
    score within atol of the plain twin's value at that rank in the plain
    product, and its rows must be distinct. Two rows a few 1e-8 apart that
    the kernel's summation order swaps across a class boundary are a tie by
    that rule and not by the anchored classes.
    """
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    if not np.array_equal(np.isneginf(kv), np.isneginf(pv)) or not np.array_equal(ki < 0, pi < 0):
        raise AssertionError(f"{what}: dead slots differ")
    live = np.isfinite(pv)
    err = float(np.abs(kv[live] - pv[live]).max()) if live.any() else 0.0
    if err > atol:
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {atol}")
    agree = tie_aware_agreement(kv, ki, pv, pi, rtol=0.0, atol=atol)
    flagged = {v["query"]: v for v in agree["violations"]}
    by_row = ""
    if flagged and plain_rows is not None:
        rows = plain_rows(list(flagged)).cpu().numpy()
        for q, scores in zip(flagged, rows):
            diff = np.nonzero(ki[q] != pi[q])[0]
            picked = ki[q][ki[q] >= 0]
            if (len(np.unique(picked)) != len(picked)
                    or np.abs(scores[ki[q, diff]] - pv[q, diff]).max() > atol):
                raise AssertionError(f"{what}: query {q} swaps rows outside ties: "
                                     f"{brief(flagged[q], kv, pv)}")
        by_row = f", {len(flagged)} flagged queries tied row by row"
    elif flagged:
        raise AssertionError(f"{what}: indices disagree outside ties in {len(flagged)} "
                             f"queries: {[brief(v, kv, pv) for v in agree['violations'][:3]]}")
    log(f"  {what}: max_abs_err {err:.3g}, index agreement raw "
        f"{agree['raw_idx_agreement']:.6f} tie-aware {agree['tie_aware_agreement']:.6f}{by_row}")
    return err


def brief(violation: dict, kv, pv) -> dict:
    """One disagreement of tie_aware_agreement without its full rows: the
    rank classes that differ, with both sides' rows and values there."""
    q = violation["query"]
    out = {"query": q, "kind": violation["kind"]}
    for c in violation.get("classes", [])[:2]:
        i, j = c["rank_class"]
        diff = [r for r, (a, b) in enumerate(zip(c["fused_ids"], c["unfused_ids"])) if a != b]
        lo, hi = max(0, i + min(diff, default=0) - 1), min(j, i + max(diff, default=0) + 2)
        out.setdefault("classes", []).append({
            "ranks": [i, j], "differ_at": [i + r for r in diff[:8]],
            "kernel_ids": c["fused_ids"][lo - i : hi - i],
            "plain_ids": c["unfused_ids"][lo - i : hi - i],
            "kernel_vals": kv[q, lo:hi].tolist(), "plain_vals": pv[q, lo:hi].tolist()})
    return out


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
    t0 = time.perf_counter()
    built, large = ck.build_all()
    log(f"  both libraries built in {time.perf_counter() - t0:.2f}s (in parallel)")
    for lib in (built, large):
        log(f"  nvcc {lib.path.name}: {lib.seconds:.2f}s")
        for line in lib.log.splitlines():
            if "Used" in line or "spill" in line or "smem" in line or "entry function" in line:
                log(f"  {line.strip()}")
    cuobjdump = Path(ck.nvcc_path()).with_name("cuobjdump")
    for lib in (built, large):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(lib.path)],
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout
        counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        log(f"  SASS of {lib.path.name}: HGMMA {counts['HGMMA']} UTMALDG {counts['UTMALDG']}")
        if min(counts.values()) == 0:
            raise AssertionError(f"{lib.path.name} lacks wgmma or TMA loads: {counts}")
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
        err = check_topk(kv, ki, pv, pi, what, atol)
        timing(what, lambda: ck.cuda_cosine_topk(e, q, size, k), e, q, size, k)
        return err, ki

    def timing(what, kernel, e, q, size, k):
        """The kernel beside torch.matmul + torch.topk (where k fits the
        live rows), CUDA events; a yardstick only."""
        ms = cuda_ms(kernel, reps=3)
        lib = "n/a (k > live rows)"
        if k <= size:
            live_e, q_e = e[:size], q.to(e.dtype)
            lib = f"{cuda_ms(lambda: torch.topk(torch.matmul(q_e, live_e.T), k), reps=3):.4f} ms"
        log(f"    timed: kernel {ms:.4f} ms, torch.matmul + torch.topk {lib}")

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
    d256 = encoder_width_case(case, corpus)
    err = max(err, d256["max_abs_err"])

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
        "merge_ms": merge_ms, "d256": d256,
    }


def encoder_width_case(case, corpus) -> dict:
    """The heap kernel at the trained encoder's width, D = 256, at the main
    batch and index: against the plain twin, then timed beside its bound
    and torch.matmul + torch.topk."""
    emb, q = corpus(CAP, ENCODER_DIM, BATCH)
    err = case(f"B={BATCH} cap={CAP} D={ENCODER_DIM} k={POOL} (the encoder's width)",
               emb, q, N_DOCS, POOL)[0]
    ms = cuda_ms(lambda: ck.cuda_cosine_topk(emb, q, N_DOCS, POOL), reps=20)
    plain_ms = cuda_ms(lambda: ck.cosine_topk_plain(emb, q, N_DOCS, POOL), reps=5)
    live, q16 = emb[:N_DOCS], q.bfloat16()
    library_ms = cuda_ms(lambda: torch.topk(torch.matmul(q16, live.T), POOL), reps=20)
    flops = 2.0 * BATCH * N_DOCS * ENCODER_DIM
    bytes_moved = N_DOCS * ENCODER_DIM * 2 + BATCH * ENCODER_DIM * 2 + BATCH * POOL * 8
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"  cosine_topk D={ENCODER_DIM}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of it)")
    return {"dim": ENCODER_DIM, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_kernel_large(gen: torch.Generator) -> dict:
    """The k > MAX_K path (csrc/cosine_topk_large.cu) against the plain twin."""
    dev = torch.device("cuda")

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    def case(what, e, q, size, k, atol=KERNEL_ATOL):
        kv, ki = ck.cuda_cosine_topk(e, q, size, k)
        pv, pi = ck.cosine_topk_plain(e, q, size, k)

        def plain_rows(ids):  # the plain twin's product, for the listed queries
            return torch.matmul(q[ids].to(e.dtype).float(), e[:size].float().T)

        err = check_topk(kv, ki, pv, pi, what, atol, plain_rows)
        ms = timing(what, lambda: ck.cuda_cosine_topk(e, q, size, k), e, q, size, k)
        return err, ki, ms

    def timing(what, kernel, e, q, size, k):
        """The kernel beside torch.matmul + torch.topk (where k fits the
        live rows), CUDA events; a yardstick only."""
        ms = cuda_ms(kernel, reps=3)
        lib = "n/a (k > live rows)"
        if k <= size:
            live_e, q_e = e[:size], q.to(e.dtype)
            lib = f"{cuda_ms(lambda: torch.topk(torch.matmul(q_e, live_e.T), k), reps=3):.4f} ms"
        log(f"    timed: kernel {ms:.4f} ms, torch.matmul + torch.topk {lib}")
        return ms

    emb = unit(torch.randn((CAP, DIM), generator=gen, device=dev)).bfloat16()
    q = unit(torch.randn((BATCH, DIM), generator=gen, device=dev))
    live, q16 = emb[:N_DOCS], q.bfloat16()
    err, rows = 0.0, []
    for k in LARGE_KS:
        err = max(err, case(f"k={k} B={BATCH} live={N_DOCS} D={DIM}", emb, q, N_DOCS, k)[0])
        ms = cuda_ms(lambda: ck.cuda_cosine_topk(emb, q, N_DOCS, k), reps=5)
        # The two passes apart; the select over the score pass's own output
        # must answer as the whole launch does.
        scores, stats = ck.large_score_pass(emb, q16, N_DOCS)
        sv, si = ck.large_select_pass(scores, stats, N_DOCS, k)
        kv, ki = ck.cuda_cosine_topk(emb, q, N_DOCS, k)
        if not (torch.equal(sv, kv) and torch.equal(si, ki)):
            raise AssertionError(f"k={k}: the two passes apart answer otherwise than the launch")
        # The select is exact on the score pass's own scores: it equals a
        # stable descending sort of them, bit for bit.
        ov, oi = torch.sort(scores[:, :N_DOCS], dim=1, descending=True, stable=True)
        if not (torch.equal(sv, ov[:, :k]) and torch.equal(si, oi[:, :k].int())):
            raise AssertionError(f"k={k}: the select differs from a stable sort of its scores")
        del ov, oi
        score_ms = cuda_ms(lambda: ck.large_score_pass(emb, q16, N_DOCS), reps=5)
        select_ms = cuda_ms(lambda: ck.large_select_pass(scores, stats, N_DOCS, k), reps=5)
        del scores, stats
        plain_ms = cuda_ms(lambda: ck.cosine_topk_plain(emb, q, N_DOCS, k), reps=2)
        library_ms = cuda_ms(lambda: torch.topk(torch.matmul(q16, live.T), k), reps=5)
        flops = 2.0 * BATCH * N_DOCS * DIM
        bytes_moved = N_DOCS * DIM * 2 + BATCH * DIM * 2 + BATCH * k * 8
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_BYTES_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        log(f"  cosine_topk large k={k}: kernel {ms:.4f} ms (score pass {score_ms:.4f} ms, "
            f"select {select_ms:.4f} ms), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of it)")
        rows.append({"k": k, "ms": ms, "score_ms": score_ms, "select_ms": select_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    err = max(err, case("k=1000 B=2047 (ragged query count)", emb, q[:2047], N_DOCS, 1000)[0])
    err = max(err, case("k=1000, 300 live rows (fewer than k)", emb, q, 300, 1000)[0])
    err = max(err, case("k=300, empty index", emb, q[:7], 0, 300)[0])
    err = max(err, case("k=5000 = live rows", emb, q, 5000, 5000)[0])
    err = max(err, case("k=1000, 1001 live rows", emb, q, 1001, 1000)[0])
    err = max(err, case("k=1000, 99999 live rows (padded score stride)", emb, q, 99_999, 1000)[0])
    # Ties across boundaries: four identical rows straddle a 128-row score
    # tile and a 1024-row compaction step of the refine path, for query i
    # the i-th such boundary, and (queries 1, 301, ...) an 8192-row step of
    # the two-read compaction; the queries run in chunks of 300 (a small
    # score budget), so the planted queries sit in different chunks.
    tie_e = emb.clone()
    planted = []
    for i in range(0, BATCH, 300):
        for qi, b in ((i, 1024 * (i // 300 + 1)), (i + 1, 8192 * (i // 300 + 1))):
            tie_e[b - 2 : b + 2] = q[qi].bfloat16()
            planted.append((qi, list(range(b - 2, b + 2))))
    budget = ck.SCORE_BUDGET
    ck.SCORE_BUDGET = 4 * ck.score_stride(N_DOCS) * 300
    try:
        e_ties, ki, _ = case(
            f"k=1000, ties across tiles, steps and {-(-BATCH // 300)} query chunks",
            tie_e, q, N_DOCS, 1000)
    finally:
        ck.SCORE_BUDGET = budget
    err = max(err, e_ties)
    for i, tied in planted:
        if ki[i, :4].tolist() != tied:
            raise AssertionError(f"query {i}: tied rows {ki[i, :4].tolist()} != {tied}")
    log(f"  planted ties: rows {planted[2][1]} first for query {planted[2][0]}, and so on")
    # Every corpus row identical: one bin holds every score, more than the
    # candidate buffer, so the select refines in the row itself.
    same_e = emb[:1].expand(CAP, DIM).contiguous()
    err_same, ki, _ = case("k=1000, every row identical (refine path)", same_e, q[:256], N_DOCS,
                           1000)
    err = max(err, err_same)
    if not torch.equal(ki.cpu(), torch.arange(1000, dtype=torch.int32).expand(256, -1)):
        raise AssertionError("identical rows: the lowest 1000 rows must come first, in order")
    # Two values a row: rows r % 50 == 0 hold one vector, the rest another.
    # Where the rare rows score higher, b* is the top bin with 2000 tied
    # candidates (k = 1000) or the bottom bin with 98000 (k = 3000); where
    # the common rows score higher, the top bin holds 98000.
    two_e = emb[1:2].expand(CAP, DIM).clone()
    two_e[::50] = emb[2]
    for k in (1000, 3000, 8192):
        err = max(err, case(f"k={k}, two values a row", two_e, q[:256], N_DOCS, k)[0])
    err = max(err, case("k=500 fp16 corpus", emb.half(), q, N_DOCS, 500)[0])
    f32_err, _, f32_ms = case("k=500 f32 corpus", emb.float(), q, N_DOCS, 500, F32_ATOL)

    # D = 100 through DenseIndex (stored zero-padded to 104 columns), and
    # D = 104 (stored as it is).
    for dim, stored in ((100, 104), (104, 104)):
        index = DenseIndex(embedder=Sha256Embedder(dim),
                           config=DenseIndexConfig(embedding_dim=dim, initial_capacity=CAP),
                           device="cuda")
        vecs = torch.randn((N_DOCS, dim), generator=gen, device=dev).cpu().numpy()
        index.add_precomputed([Document(str(i), "") for i in range(N_DOCS)], vecs)
        if tuple(index._emb.shape) != (CAP, stored) or \
                tuple(index.embeddings.shape) != (N_DOCS, dim):
            raise AssertionError(f"padded storage {tuple(index._emb.shape)}")
        q_dim = unit(torch.randn((BATCH, dim), generator=gen, device=dev))
        for k in (POOL, 1000):
            kv, ki = index.search_batch([], top_k=k, q_vecs=q_dim)
            pv, pi = ck.cosine_topk_plain(index._emb, index._padded(q_dim), N_DOCS, k)
            what = f"D={dim} via DenseIndex (stored {stored}), k={k}"
            padded_q = index._padded(q_dim)
            err = max(err, check_topk(
                torch.from_numpy(kv), torch.from_numpy(ki), pv, pi, what,
                plain_rows=lambda ids: torch.matmul(padded_q[ids].to(index._emb.dtype).float(),
                                                    index._emb[:N_DOCS].float().T)))
            timing(what, lambda: ck.cuda_cosine_topk(index._emb, padded_q, N_DOCS, k),
                   index._emb, padded_q, N_DOCS, k)
        del index
    main = next(r for r in rows if r["k"] == 1000)  # the k the persist path runs
    return {
        "name": "cosine_topk_large", "route": "cuda",
        "source": "rag_uq_tpu_torch/csrc/cosine_topk_large.cu",
        "replaces": "rag_uq_tpu/ops/pallas_topk.py:157",
        "max_abs_err": err, "f32_max_abs_err": f32_err, "f32_k500_ms": f32_ms,
        **{key: main[key] for key in ("k", "ms", "score_ms", "select_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
        "cases": rows,
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


def timed(fn):
    """(fn(), seconds) on the host clock, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stage_times(retriever, router, queries) -> dict:
    """Split one 2048-query request into host encoding and the fused query,
    and time the fused query's BM25 pool in both sparse modes (host clock,
    synchronized)."""
    q_vecs, t_embed = timed(lambda: retriever.dense_index.embed_queries(queries))
    qterms, t_terms = timed(lambda: fused_mod.encode_for_fused(
        retriever.bm25_index, queries, active_compaction=True))
    state = retriever._fused_state()
    dev = retriever.bm25_index._device
    fused = fused_mod.make_fused_hybrid_query(
        router_module=router.module, k=K, pool=POOL, beam=dev["beam"], sparse_mode="scatter")
    _, t_fused = timed(lambda: fused(state, q_vecs, qterms))
    twotier = fused_mod.make_fused_hybrid_query(
        router_module=router.module, k=K, pool=POOL, beam=dev["beam"], nonneg=dev["nonneg"],
        sparse_mode="twotier")
    _, t_fused_twotier = timed(lambda: twotier(state, q_vecs, qterms))
    _, t_bm25 = timed(lambda: scatter_pool(state, qterms, dev))
    _, t_twotier = timed(lambda: twotier_pool(state, qterms, dev))
    log(f"  one 2048-query request: host query embedding {t_embed:.4f} s, host term "
        f"encoding {t_terms:.4f} s (active rows {qterms['active_rows'].shape[0]}), "
        f"fused query {t_fused:.4f} s (scatter) / {t_fused_twotier:.4f} s (twotier); "
        f"BM25 pool {t_bm25:.4f} s (scatter) / {t_twotier:.4f} s (twotier, impact "
        f"{tuple(dev['impact'].shape)} {dev['impact'].dtype}, beam {dev['beam']})")
    return {"scatter_pool_s": t_bm25, "twotier_pool_s": t_twotier}


def scatter_pool(state, qterms, dev):
    return fused_mod.bm25_ops.topk_lowscatter(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qterms["qtids_base"], POOL, beam=dev["beam"], impact_scale=state["impact_scale"],
        active_rows=qterms["active_rows"], rows_compact=qterms["rows_compact"],
        low_blocks=state.get("low_blocks"), low_row=state.get("low_row"))


def twotier_pool(state, qterms, dev):
    return fused_mod.bm25_ops.topk_twotier(
        state["low_ranges"], state["post_packed"], state["term_row"], state["impact"],
        qterms["qtids_base"], POOL, beam=dev["beam"], impact_scale=state["impact_scale"],
        nonneg=dev["nonneg"])


def serve(service, requests):
    """Each request through service.search, with the kernel's launch counts
    set to 0 just before and read just after. Returns (results, seconds,
    launches, large_launches)."""
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    results, seconds = [], []
    for _, queries in requests:
        t0 = time.perf_counter()
        results.append(service.search(queries, k=K))
        seconds.append(time.perf_counter() - t0)
    launches, large = ck.cuda_cosine_topk.launches, ck.cuda_cosine_topk.large_launches
    if launches < len(requests):
        raise AssertionError(f"the kernel ran {launches} times for {len(requests)} requests")
    return results, seconds, launches, large


def source_recall(requests, results, what: str) -> float:
    """Well-formed hits (K distinct a query) and the share of queries whose
    source passage is among them; fails under 0.5."""
    hits = found = 0
    for (src, _), res in zip(requests, results):
        if len(res) != len(src):
            raise AssertionError(f"{what}: a request lost queries")
        for s, row in zip(src, res):
            if len(row) != K:
                raise AssertionError(f"{what}: a query returned {len(row)} hits, not {K}")
            ids = [h["doc_id"] for h in row]
            if len(set(ids)) != K:
                raise AssertionError(f"{what}: duplicate hits")
            hits += 1
            found += str(s) in ids
    recall = found / hits
    if recall < 0.5:
        raise AssertionError(f"{what}: source-passage recall@{K} {recall:.3f}")
    return recall


def zipf_passages(rng, n: int) -> np.ndarray:
    """[n, DOC_LEN] term ids, Zipf over VOCAB (bench.py's recipe)."""
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return rng.choice(VOCAB, size=(n, DOC_LEN), p=p)


def query_batch(rng, doc_ids: np.ndarray, n: int, offset: int = 0):
    """(source positions, queries): 6 terms taken from a source passage."""
    src = rng.integers(0, doc_ids.shape[0], size=n)
    terms = doc_ids[src][:, :: DOC_LEN // 6][:, :6]
    return src + offset, [" ".join(map(str, row)) for row in terms]


def phase_slice(seed: int, device_name: str) -> dict:
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    doc_ids = zipf_passages(rng, N_DOCS)
    texts = [" ".join(map(str, row)) for row in doc_ids]
    docs = [Document(str(i), t) for i, t in enumerate(texts)]
    log(f"  corpus: {N_DOCS} passages x {DOC_LEN} terms, Zipf over {VOCAB}: "
        f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    # delta_sync_fraction changes nothing until the ingest phase adds docs.
    bm25_config = BM25Config(delta_sync_fraction=DELTA_FRACTION)
    retriever = HybridRetriever(bm25_config=bm25_config,
                                embedder_config=EmbedderConfig(dim=DIM), device="cuda")
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

    requests = [query_batch(rng, doc_ids, BATCH) for _ in range(3)] + [query_batch(rng, doc_ids, 1)]
    router = RetrievalRouter(router_recipe_v2(), seed=seed, device="cuda")
    service = QueryService(retriever, router=router, max_batch=BATCH, sparse_mode="scatter")
    try:
        results, seconds, launches, _ = serve(service, requests)
    finally:
        service.close()
    recall = source_recall(requests, results, "scatter")
    lat = sorted(seconds[:3])
    log(f"  served {sum(len(s) for s, _ in requests)} queries in {len(requests)} requests, "
        f"kernel launches {launches}, source recall@{K} {recall:.4f} (chance {K / N_DOCS:.0e})")
    log(f"  2048-query request latency s {[round(x, 4) for x in seconds[:3]]}, "
        f"median {lat[1]:.4f} s = {BATCH / lat[1]:.1f} queries/s; single query "
        f"{seconds[3]:.4f} s; on {device_name}")

    pools = stage_times(retriever, router, requests[1][1])

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
    return {"retriever": retriever, "router": router, "rng": rng, "doc_ids": doc_ids,
            "requests": requests, "results": results, "launches": launches,
            "median_s": lat[1], **pools}


def phase_twotier(ctx: dict) -> int:
    """The JAX package's default BM25 pool (topk_twotier) behind QueryService."""
    retriever, router, requests = ctx["retriever"], ctx["router"], ctx["requests"][:3]
    service = QueryService(retriever, router=router, max_batch=BATCH, sparse_mode="twotier")
    try:
        results, seconds, launches, _ = serve(service, requests)
    finally:
        service.close()
    recall = source_recall(requests, results, "twotier")
    lat = sorted(seconds)
    log(f"  twotier: 3 requests, kernel launches {launches}, source recall@{K} {recall:.4f}, "
        f"latency s {[round(x, 4) for x in seconds]}, median {lat[1]:.4f} s "
        f"(scatter {ctx['median_s']:.4f} s)")
    # The served hits against the scatter service's, under the tie rule.
    agree_min = 1.0
    for res_t, res_s in zip(results, ctx["results"]):
        tv = np.array([[h["score"] for h in row] for row in res_t], dtype=np.float32)
        sv = np.array([[h["score"] for h in row] for row in res_s], dtype=np.float32)
        ti = np.array([[int(h["doc_id"]) for h in row] for row in res_t])
        si = np.array([[int(h["doc_id"]) for h in row] for row in res_s])
        agree = tie_aware_agreement(tv, ti, sv, si, rtol=1e-4, atol=1e-5)
        agree_min = min(agree_min, agree["tie_aware_agreement"])
        if agree["tie_aware_agreement"] != 1.0:
            raise AssertionError(f"twotier vs scatter hits: {agree['violations'][:2]}")
    # The two BM25 pools themselves, on one request's terms.
    state = retriever._fused_state()
    dev = retriever.bm25_index._device
    qterms = fused_mod.encode_for_fused(retriever.bm25_index, requests[0][1],
                                        active_compaction=True)
    tv, ti = twotier_pool(state, qterms, dev)
    sv, si = scatter_pool(state, qterms, dev)
    tv, ti, sv, si = (t.cpu().numpy() for t in (tv, ti, sv, si))
    live = (tv > 0) | (sv > 0)  # the positive-scores contract applies to both
    tv, sv = np.where(live, tv, 0.0), np.where(live, sv, 0.0)
    ti, si = np.where(live, ti, -1), np.where(live, si, -1)
    pool_agree = tie_aware_agreement(tv, ti, sv, si, rtol=1e-5, atol=1e-5)
    if pool_agree["tie_aware_agreement"] != 1.0:
        raise AssertionError(f"twotier vs scatter pool: {pool_agree['violations'][:2]}")
    log(f"  twotier vs scatter: hits tie-aware {agree_min:.6f}; BM25 pool raw "
        f"{pool_agree['raw_idx_agreement']:.6f}, tie-aware "
        f"{pool_agree['tie_aware_agreement']:.6f}, max |score diff| "
        f"{pool_agree['rankwise_max_abs_score_diff']:.3g}")
    return launches


def phase_ingest(ctx: dict) -> int:
    """Live ingest through QueryService with delta_sync_fraction > 0."""
    retriever, rng = ctx["retriever"], ctx["rng"]
    bm25 = retriever.bm25_index
    base_device, base_docs, generation = bm25._device, bm25._base["docs"], bm25.sync_generation
    new_ids = zipf_passages(rng, N_INGEST)
    new_docs = [Document(str(N_DOCS + i), " ".join(map(str, row)))
                for i, row in enumerate(new_ids)]
    requests = [query_batch(rng, new_ids, N_INGEST, offset=N_DOCS)]
    service = QueryService(retriever, router=ctx["router"], max_batch=BATCH,
                           sparse_mode="scatter")
    try:
        t0 = time.perf_counter()
        stats = service.ingest(new_docs)
        t_ingest = time.perf_counter() - t0
        results, seconds, launches, _ = serve(service, requests)
    finally:
        service.close()
    if stats["total_documents"] != N_DOCS + N_INGEST or len(retriever) != N_DOCS + N_INGEST:
        raise AssertionError(f"ingest stats {stats}")
    if bm25._device is not base_device or bm25._base["docs"] != base_docs:
        raise AssertionError("the ingest ran a full resync")
    if bm25._delta_device is None or bm25.sync_generation != generation + 1:
        raise AssertionError(f"no delta sync (generation {generation} -> {bm25.sync_generation})")
    recall = source_recall(requests, results, "new passages")
    log(f"  ingested {N_INGEST} passages in {t_ingest:.4f} s (host add + delta sync), no full "
        f"resync (base device state kept, generation +1); {N_INGEST} queries from the new "
        f"passages in {seconds[0]:.4f} s, source recall@{K} {recall:.4f}, kernel launches "
        f"{launches}")

    # The delta BM25 pool (the two-tier base pool and the delta's, merged)
    # against an independent frozen-statistics oracle: the base's scatter
    # pool (the same bf16 impacts) beside the delta's exhaustive scores of
    # every new passage, one exact top-k. Queries from old and new passages.
    delta = bm25._delta_device
    dev = bm25._device
    _, old_q = query_batch(rng, ctx["doc_ids"], 512)
    queries = old_q + requests[0][1][:512]
    vals, idx = bm25.search_batch(queries, top_k=POOL, exact=False)
    qterms = fused_mod.encode_for_fused(bm25, queries, active_compaction=True)
    state = retriever._fused_state()
    bv, bi = scatter_pool(state, qterms, dev)
    delta_scores = fused_mod.bm25_ops.score_all(delta["indptr"], delta["post_doc"],
                                                delta["post_w"], qterms["qtids"],
                                                delta["n_docs_cap"], delta["max_df"])
    new_rows = torch.arange(base_docs, base_docs + N_INGEST, device=bi.device)
    cat_v = torch.cat([bv, delta_scores[:, :N_INGEST]], dim=1)
    cat_i = torch.cat([bi.long(), new_rows.expand(len(queries), -1)], dim=1)
    ov, sel = fused_mod.bm25_ops.topk_from_scores(cat_v, POOL)
    oi = torch.where(sel >= 0, torch.gather(cat_i, 1, sel.clamp(min=0).long()), -1)
    agree = tie_aware_agreement(vals, idx, ov.cpu().numpy(), oi.cpu().numpy(),
                                rtol=1e-5, atol=1e-5)
    if agree["tie_aware_agreement"] != 1.0:
        raise AssertionError(f"delta pool vs frozen-stats oracle: {agree['violations'][:2]}")
    from_delta = float((idx >= base_docs).mean())
    # The fused answers with the live delta against a full resync's (new
    # idf and avgdl): the same hits up to the bounded staleness.
    live_v, live_p = retriever.hybrid_search_batch(queries, top_k=K, router=ctx["router"])
    full_state = fused_mod.build_index_state(retriever.dense_index, bm25, allow_delta=False)
    if bm25._delta_device is not None or bm25._base["docs"] != N_DOCS + N_INGEST:
        raise AssertionError("_require_full_sync did not collapse the delta")
    fused = fused_mod.make_fused_hybrid_query(
        router_module=ctx["router"].module, k=K, pool=POOL, beam=bm25._device["beam"],
        nonneg=bm25._device["nonneg"])
    full_v, full_p = fused(full_state, retriever.dense_index.embed_queries(queries),
                           fused_mod.encode_for_fused(bm25, queries))
    full_p = full_p.cpu().numpy()
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(live_p, full_p)])
    if overlap < 0.8:
        raise AssertionError(f"delta answers overlap a full resync's only {overlap:.3f}")
    log(f"  delta BM25 pool vs frozen-stats oracle ({len(queries)} queries): raw "
        f"{agree['raw_idx_agreement']:.6f}, tie-aware {agree['tie_aware_agreement']:.6f}, "
        f"max |score diff| {agree['rankwise_max_abs_score_diff']:.3g}, {from_delta:.1%} of "
        f"the pool from the delta; fused top-{K} overlap with a full resync {overlap:.4f}")
    return launches


def http_json(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_persist(ctx: dict) -> tuple:
    """Save, reload onto the card, answer identically; then HTTP."""
    retriever, rng = ctx["retriever"], ctx["rng"]
    n = len(retriever)
    _, queries = query_batch(rng, ctx["doc_ids"], BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        bm25_path, dense_dir = str(Path(tmp) / "bm25.json"), str(Path(tmp) / "dense")
        t0 = time.perf_counter()
        retriever.bm25_index.save(bm25_path)
        retriever.dense_index.save(dense_dir)
        t_save = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        loaded = HybridRetriever(bm25_persist_path=bm25_path, dense_persist_directory=dense_dir,
                                 bm25_config=BM25Config(delta_sync_fraction=DELTA_FRACTION),
                                 embedder_config=EmbedderConfig(dim=DIM), device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    log(f"  saved {n} passages ({size / 2**20:.1f} MiB) in {t_save:.2f} s, reloaded onto the "
        f"card in {t_load:.2f} s")
    if len(loaded) != n or loaded.documents.ids != retriever.documents.ids:
        raise AssertionError("the reloaded index lost documents")
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    # The reloaded device state equals the original's, array by array.
    a_state, b_state = retriever._fused_state(), loaded._fused_state()
    if set(a_state) != set(b_state):
        raise AssertionError(f"state keys {sorted(set(a_state) ^ set(b_state))}")
    for key, value in a_state.items():
        same = (torch.equal(value, b_state[key]) if isinstance(value, torch.Tensor)
                else value == b_state[key])
        if not same:
            raise AssertionError(f"the reloaded state differs at {key}")
    # The deterministic paths answer bit for bit: the two-tier fused query
    # and DenseIndex.search_batch at k = 1000 (the large-k kernels). The
    # scatter pool's float atomics sum in another order on every run, so
    # its answers are held under the tie rule.
    a = retriever.hybrid_search_batch(queries, top_k=K, router=ctx["router"])
    b = loaded.hybrid_search_batch(queries, top_k=K, router=ctx["router"])
    if not (np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])):
        raise AssertionError("the reloaded index answers differently (twotier)")
    a = retriever.dense_index.search_batch(queries, top_k=1000)
    b = loaded.dense_index.search_batch(queries, top_k=1000)
    if not (np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])):
        raise AssertionError("the reloaded dense index answers differently at k=1000")
    a = retriever.hybrid_search_batch(queries, top_k=K, router=ctx["router"], sparse_mode="scatter")
    b = loaded.hybrid_search_batch(queries, top_k=K, router=ctx["router"], sparse_mode="scatter")
    agree = tie_aware_agreement(a[0], a[1], b[0], b[1], rtol=1e-4, atol=1e-5)
    if agree["tie_aware_agreement"] != 1.0:
        raise AssertionError(f"the reloaded index answers differently (scatter): "
                             f"{agree['violations'][:2]}")
    log(f"  reloaded index: every device array equal; {BATCH} queries answered bit for bit "
        f"by the two-tier fused query and by DenseIndex.search_batch at k=1000, and by the "
        f"scatter fused query under the tie rule (raw {agree['raw_idx_agreement']:.6f})")

    service = QueryService(loaded, max_batch=BATCH)
    server = serve_http(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = http_json(port, "/healthz")
        hits = http_json(port, "/search", {"queries": queries[:8], "k": K})["results"]
        stats = http_json(port, "/ingest", {"documents": [
            {"id": "live-http", "text": "zzyzx quokka 17 23"}]})
        fresh = http_json(port, "/search", {"queries": ["zzyzx quokka"], "k": 3})["results"][0]
        answer = http_json(port, "/answer", {"question": queries[0], "k": 3})
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    launches, large = ck.cuda_cosine_topk.launches, ck.cuda_cosine_topk.large_launches
    if thread.is_alive():
        raise AssertionError("the HTTP server thread did not stop")
    if health != {"status": "ok", "documents": n}:
        raise AssertionError(f"/healthz {health}")
    if len(hits) != 8 or any(len(row) != K for row in hits):
        raise AssertionError("/search returned malformed hits")
    if stats.get("total_documents") != n + 1 or fresh[0]["doc_id"] != "live-http":
        raise AssertionError(f"/ingest then /search: {stats} {fresh[:1]}")
    if loaded.bm25_index._delta_device is None:
        raise AssertionError("/ingest ran a full resync")
    if answer["answer"] != answer["passages"][0]["text"] or not 0.0 <= answer["confidence"] <= 1.0:
        raise AssertionError(f"/answer {answer['answer'][:40]!r} {answer['confidence']}")
    if launches < 1 or large < 1:
        raise AssertionError(f"persist path launches {launches}, large-k {large}")
    log(f"  HTTP on 127.0.0.1:{port}: /healthz, /search, /ingest (delta, no resync) then "
        f"/search finds it, /answer (confidence {answer['confidence']:.4f}); kernel launches "
        f"{launches} (large-k {large})")
    return launches, large


def read_jsonl(path: Path, n=None) -> list:
    with open(path) as f:
        return [json.loads(line) for line in itertools.islice(f, n)]


def phase_answer(device: str = "cuda") -> dict:
    """The JAX server's default configuration on the card: the trained
    encoder, the router and TinyLM from the checkpoints in the checkout,
    /answer under both policies, greedy decoding against the JAX fixture,
    MC and conformal UQ. (``device`` is "cuda" in every run of this script.)"""
    # Checkpoints: the demo run's triple, and main's two default paths.
    t0 = time.perf_counter()
    encoder = load_encoder_checkpoint(str(DEMO_ENCODER), device=device)
    router = RetrievalRouter(device=device)
    load_router_checkpoint(router, str(DEMO_ROUTER))
    lm = load_lm_checkpoint(str(DEMO_LM), device=device)
    with tempfile.TemporaryDirectory() as tmp:
        args = serve_mod.parse_args(["--bm25-path", f"{tmp}/bm25.json", "--dense-dir",
                                     f"{tmp}/dense", "--device", device])
        default_service, default_lm = serve_mod.build_service(args)
        default_service.close()
    default_encoder = default_service.retriever.dense_index.embedder
    if not (isinstance(default_encoder, TransformerEmbedder) and default_encoder.dim == ENCODER_DIM
            and isinstance(default_lm, TinyLM) and default_lm.device.type == device
            and args.encoder_checkpoint == "models/encoder/encoder.msgpack"
            and args.lm_checkpoint == "models/tiny_lm/tiny_lm.msgpack"):
        raise AssertionError("main's defaults did not load the shipped encoder and TinyLM")
    if router.config.feature_set != "pool7" or router.trained_num_passages != 20:
        raise AssertionError(f"router checkpoint: {router.config} {router.trained_num_passages}")
    del default_service, default_lm, default_encoder
    log(f"  checkpoints: encoder {DEMO_ENCODER} ({encoder.config.dim}-d, "
        f"{encoder.config.num_layers} layers), router {DEMO_ROUTER} ({router.config.feature_set}), "
        f"TinyLM {DEMO_LM} ({lm.config.dim}-d, {lm.config.num_layers} layers), and main's "
        f"defaults: {time.perf_counter() - t0:.2f}s")

    # Embedding: the corpus on the card, 64 passages held to the CPU.
    rows = read_jsonl(RUN / "corpus.jsonl")
    texts = [r["text"] for r in rows]
    vecs, t_embed = timed(lambda: encoder.encode(texts))
    cpu = TransformerEmbedder(encoder.config, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in encoder.model.state_dict().items()})
    cos = (cpu.encode(texts[:64]) * vecs[:64]).sum(axis=1)
    if cos.min() < 0.999 or not np.isfinite(vecs).all():
        raise AssertionError(f"encoder on the card vs the CPU: min cosine {cos.min()}")
    log(f"  encoder: {len(texts)} passages in {t_embed:.4f} s = {len(texts) / t_embed:.1f} "
        f"passages/s; 64 against the CPU, min cosine {cos.min():.6f}")

    # The index and the service.
    retriever, t_index = timed(lambda: build_demo_index(encoder, rows, device))
    service = QueryService(retriever, router=router)
    qa = read_jsonl(RUN / "nq.jsonl", N_RECALL)
    kernel_err = answer_kernel_cases(retriever.dense_index, [r["question"] for r in qa],
                                     service.pool_size)
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    _, pos = retriever.dense_index.search_batch([r["question"] for r in qa], top_k=10)
    ids = retriever.documents.ids
    recall = float(np.mean([len(set(r["gold_doc_ids"]) & {ids[p] for p in row if p >= 0})
                            / len(r["gold_doc_ids"]) for r, row in zip(qa, pos)]))
    recall_launches = ck.cuda_cosine_topk.launches
    log(f"  index: {len(retriever)} passages (BM25 + D={ENCODER_DIM} dense) in {t_index:.2f} s; "
        f"dense-only recall@10 of gold_doc_ids over {N_RECALL} questions {recall:.4f}, "
        f"kernel launches {recall_launches}")
    if recall < MIN_DENSE_RECALL or recall_launches < 1:
        raise AssertionError(f"dense recall@10 {recall} (gate {MIN_DENSE_RECALL}), "
                             f"launches {recall_launches}")

    fixture = json.loads(FIXTURE.read_text())
    if fixture["questions"] != [r["question"] for r in qa[:N_ANSWER]]:
        raise AssertionError("the fixture's questions are not the first of nq.jsonl")
    try:
        answers, launches, trips = serve_answers(service, lm, fixture)
    finally:
        service.close()
    em = float(np.mean([max(exact_match(a["answer"], g) for g in gold)
                        for a, gold in zip(answers, fixture["answers"])]))
    other_ctx = [i for i, (a, c) in enumerate(zip(answers, fixture["contexts"]))
                 if a["passages"][0]["text"] != c]
    log(f"  /answer: {N_ANSWER} concat + {N_PER_PASSAGE} per_passage, all well formed; exact "
        f"match {em:.4f} (fixture's JAX greedy {fixture['exact_match']:.4f}); top-1 passage as "
        f"the fixture's for {N_ANSWER - len(other_ctx)}/{N_ANSWER} (not for questions "
        f"{other_ctx}); kernel launches {launches}; round trip median (first) "
        f"{trips['concat']['median']:.4f} s ({trips['concat']['first']:.4f}) "
        f"concat, {trips['per_passage']['median']:.4f} s ({trips['per_passage']['first']:.4f}) "
        f"per_passage")
    if abs(em - fixture["exact_match"]) > EM_SLACK or launches < N_ANSWER:
        raise AssertionError(f"/answer exact match {em} vs {fixture['exact_match']}, "
                             f"launches {launches}")

    # Greedy decoding of the fixture's prompts against the JAX answers.
    prompts = [build_qa_prompt(q, c) for q, c in zip(fixture["questions"], fixture["contexts"])]
    n = len(prompts)
    (greedy, mean_lp, _), t_greedy = timed(lambda: lm.generate_batch_scored(
        prompts, [0.1] * n, [fixture["top_p"]] * n, max_tokens=fixture["max_tokens"], seed=0))
    same = sum(a == b for a, b in zip(greedy, fixture["jax_greedy"]))
    lp_err = float(np.abs(np.asarray(mean_lp) - fixture["jax_mean_logprob"])[
        [i for i in range(n) if greedy[i] == fixture["jax_greedy"][i]]].max())
    log(f"  greedy: {same}/{n} answers equal to the JAX fixture's (gate {MIN_GREEDY_SAME}); max "
        f"|mean log-prob diff| where equal {lp_err:.4f}; differing: "
        f"{[(g, j) for g, j in zip(greedy, fixture['jax_greedy']) if g != j][:4]}")
    if same < MIN_GREEDY_SAME:
        raise AssertionError(f"greedy answers: {same}/{n} equal to the JAX fixture's")
    gen_times = {"B=32 greedy": (t_greedy, dict(lm.last_stats))}
    for b in (1, 3):
        _, t = timed(lambda: lm.generate_batch_scored(prompts[:b], [0.1] * b, [0.9] * b, seed=1))
        gen_times[f"B={b}"] = (t, dict(lm.last_stats))

    # MC: 16 questions x K = 10 in one generate call, twice with one seed.
    mc_out = []
    for _ in range(2):
        mc = MCDropoutConfidence(lm, n_samples=MC_SAMPLES, seed=7, device=device)
        res, t_mc = timed(lambda: mc.get_confidence_batch(
            ConformalRAG._MC_INSTRUCTION, fixture["contexts"][:N_MC], fixture["questions"][:N_MC]))
        mc_out.append(res)
    gen_times[f"B={N_MC * MC_SAMPLES} (MC)"] = (t_mc, dict(lm.last_stats))
    conf = [r.confidence for r in mc_out[0]]
    if len(conf) != N_MC or not all(0.0 <= c <= 1.0 for c in conf):
        raise AssertionError(f"MC confidences {conf}")
    if [r.answers for r in mc_out[0]] != [r.answers for r in mc_out[1]]:
        raise AssertionError("MC: the same seed gave other answers on the card")
    log(f"  MC: {N_MC} x {MC_SAMPLES} samples in one call, {t_mc:.4f} s; confidences "
        f"{min(conf):.3f}-{max(conf):.3f}, mean {np.mean(conf):.3f}; same seed, same answers")
    for name, (t, st) in gen_times.items():
        log(f"  TinyLM generate {name}: {t:.4f} s, {st['rows']} rows (padded), prefill "
            f"{st['prefill']}, {st['steps']} decode steps, {st['tokens']} tokens = "
            f"{st['tokens'] / t:.1f} tokens/s")

    decode = {f"B={b}": decode_profile(lm, prompts[:b]) for b in (1, N_ANSWER)}
    conformal = check_conformal(lm, device)
    return {"launches": launches, "recall_launches": recall_launches, "recall": recall,
            "kernel_max_abs_err": kernel_err,
            "em": em, "greedy_same": same, "passages_per_s": len(texts) / t_embed,
            "generate_s": {k: v[0] for k, v in gen_times.items()}, "round_trip_s": trips,
            "decode_profile": decode, "conformal": conformal}


def answer_kernel_cases(index, questions, pool: int) -> float:
    """The heap kernel against its plain twin at the answer path's own
    shapes, on the demo index's vectors: the recall queries (B = 500, k = 10)
    and one question at the service's pool width (B = 1, k = 50), both over
    the 5,000 live D = 256 rows. Returns the larger max |diff|."""
    emb, size = index._emb, len(index)
    err = 0.0
    for what, q, k in ((f"recall B={len(questions)} k=10", index.embed_queries(questions), 10),
                       (f"/answer pool B=1 k={pool}", index.embed_queries(questions[:1]), pool)):
        kv, ki = ck.cuda_cosine_topk(emb, q, size, k)
        pv, pi = ck.cosine_topk_plain(emb, q, size, k)

        def plain_rows(ids, q=q):  # the plain twin's product, for the listed queries
            return torch.matmul(q[ids].to(emb.dtype).float(), emb[:size].float().T)

        err = max(err, check_topk(kv, ki, pv, pi, f"answer path {what} over {size} live rows "
                                  f"D={ENCODER_DIM}", KERNEL_ATOL, plain_rows))
    return err


def decode_profile(lm, prompts) -> dict:
    """One greedy generate call under torch.profiler: wall time, the
    device's busy time (the sum of its kernels' and copies' durations) and
    the number of them, each per decode step, and the device's idle share."""
    n = len(prompts)
    run = lambda: lm.generate_batch_scored(prompts, [0.1] * n, [1e-6] * n, max_tokens=32, seed=0)
    run()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, wall = timed(run)
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in on_device) * 1e-6
    steps = lm.last_stats["steps"] + 1  # the decode steps and the prefill
    out = {"wall_ms_per_step": wall / steps * 1e3, "busy_ms_per_step": busy_s / steps * 1e3,
           "device_ops_per_step": len(on_device) / steps, "idle_share": 1.0 - busy_s / wall,
           "steps": steps, "wall_s": wall}
    log(f"  decode profile B={n}: {steps} steps (prefill included) in {wall:.4f} s, "
        f"{out['wall_ms_per_step']:.3f} ms a step on the host clock, device busy "
        f"{out['busy_ms_per_step']:.3f} ms a step in {out['device_ops_per_step']:.1f} kernels "
        f"and copies, idle share {out['idle_share']:.1%}")
    return out


def build_demo_index(encoder, rows, device: str) -> HybridRetriever:
    retriever = HybridRetriever(embedder=encoder, device=device)
    retriever.add_documents([Document.from_dict(r) for r in rows])
    retriever._fused_state()
    return retriever


def serve_answers(service, lm, fixture):
    """/answer through serve_http on 127.0.0.1:0: the fixture's questions
    with the concat policy, the first few with per_passage. Returns (concat
    responses, dense kernel launches, the first and the median round trip a
    policy in seconds)."""
    server = serve_http(service, llm=lm, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    trips = {"concat": [], "per_passage": []}
    try:
        answers, per_passage = [], []
        for policy, out, questions in (("concat", answers, fixture["questions"]),
                                       ("per_passage", per_passage,
                                        fixture["questions"][:N_PER_PASSAGE])):
            for q in questions:
                t0 = time.perf_counter()
                out.append(http_json(port, "/answer", {"question": q, "context_policy": policy}))
                trips[policy].append(time.perf_counter() - t0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = ck.cuda_cosine_topk.launches
    for a in answers + per_passage:
        hits = a.get("passages")
        if not (isinstance(a.get("answer"), str) and 0.0 <= a.get("confidence", -1) <= 1.0
                and isinstance(hits, list) and 0 < len(hits) <= 10
                and all({"doc_id", "score", "text"} <= set(h) for h in hits)):
            raise AssertionError(f"/answer malformed: {str(a)[:200]}")
    if not all(a["answer"] for a in answers[:4]):
        raise AssertionError("/answer returned empty answers")
    return answers, launches, {k: {"first": v[0], "median": float(np.median(v))}
                               for k, v in trips.items()}


def check_conformal(lm, device: str) -> dict:
    """The calibration set of the demo run, on the card: the threshold and
    p-values against numpy on the same scores."""
    with tempfile.TemporaryDirectory() as tmp:
        db = Path(tmp) / "calibration.db"
        db.write_bytes((RUN / "calibration.db").read_bytes())  # the checkout's file stays as it is
        conformal = ConformalRAG(lm, calibration_db_path=str(db), alpha=0.1, device=device)
        scores = np.asarray(conformal.calibration_scores, dtype=np.float32)
        if conformal._scores_device.device.type != device or len(scores) != 500:
            raise AssertionError(f"calibration scores: {len(scores)} on "
                                 f"{conformal._scores_device.device}")
        n = len(scores)
        level = min(np.ceil((n + 1) * (1 - np.float32(0.1))) / n, 1.0)
        ref = float(np.quantile(scores, level, method="linear"))
        threshold = conformal.get_conformal_threshold()
        estimates = [0.0, float(np.median(scores)), threshold, float(scores.max()), 1.0]
        p_err = max(abs(float(conformal_p_value_device(conformal._scores_device, e))
                        - (np.sum(scores >= np.float32(e)) + 1) / (n + 1)) for e in estimates)
        stats = conformal.get_calibration_stats()
    if abs(threshold - ref) > 1e-6 or p_err > 1e-6:
        raise AssertionError(f"conformal on the card: threshold {threshold} vs numpy {ref}, "
                             f"p-value error {p_err}")
    log(f"  conformal: {n} calibration scores on the card, threshold {threshold:.6f} (numpy "
        f"{ref:.6f}), p-values within {p_err:.2g} of a numpy count; mean {stats['mean']:.4f}")
    return {"n": n, "threshold": threshold, "numpy_threshold": ref, "p_value_err": p_err}


def instances(module, name: str):
    """Patch ``module.name`` (a class) so each instance it makes is kept:
    returns (the patcher, the list of instances)."""
    cls, made = getattr(module, name), []

    def make(*args, **kwargs):
        made.append(cls(*args, **kwargs))
        return made[-1]

    return mock.patch.object(module, name, make), made


def same_state(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k].to(sa[k].device)) for k in sa)


def profiled(fn, top: int = 0):
    """fn() under torch.profiler: (host seconds, device-busy seconds, device
    ops, the ``top`` kernel names by summed device seconds) of the call, the
    device's kernels and copies summed."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        _, wall = timed(fn)
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in on_device:
        name = kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() * 1e-6
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return wall, sum(by_name.values()), len(on_device), heavy


def kernel_name(name: str) -> str:
    """A device kernel's name cut to its function and innermost functor,
    e.g. "vectorized_elementwise_kernel/MulFunctor"."""
    head = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", "")).split("(")[0]
    base = head.split("<")[0].split("::")[-1][:80]
    inner = re.findall(r"(\w+(?:Functor|Op|_functor|Epilogue|_cuda))\b", head)
    return f"{base}/{inner[-1]}" if inner else base


def train_router_path(retriever, qa_rows, tmp: Path, device: str) -> dict:
    """cli/train_router.py on the card: data from the demo retriever (the
    heap kernel's dense pool), then the pool7 router of the demo run."""
    split = int(0.9 * len(qa_rows))
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    (train, val), t_prep = timed(lambda: (
        train_router_cli.prepare_training_data(retriever, qa_rows[:split], ROUTER_POOL),
        train_router_cli.prepare_training_data(retriever, qa_rows[split:], ROUTER_POOL)))
    launches = ck.cuda_cosine_topk.launches
    if launches < 1 or train[0].shape != (split, ROUTER_POOL) or not np.isfinite(train[0]).all():
        raise AssertionError(f"router data: launches {launches}, shape {train[0].shape}")
    config = RouterConfig(hidden_dim=64, num_layers=2, dropout=0.1, feature_set="pool7")
    patch, routers = instances(train_router_cli, "RetrievalRouter")
    with patch:
        results = train_router_cli.train_router(
            train, val, router_config=config,
            train_config=TrainConfig(checkpoint_dir=str(tmp / "router")),
            output_dir=str(tmp / "router"), device=device)
    router = routers[0]
    meta = json.loads((tmp / "router/final_router.msgpack.json").read_text())
    losses = meta["train_losses"]
    reloaded = RetrievalRouter(device=device)
    load_router_checkpoint(reloaded, str(tmp / "router/final_router.msgpack"))
    steps = results["epochs_trained"] * -(-split // TrainConfig().batch_size)
    # One step alone under the profiler (a fresh trainer on a copy).
    probe = RouterTrainer(RetrievalRouter(config, device=device),
                          config=TrainConfig(checkpoint_dir=str(tmp / "probe")))
    batch = tuple(a[:TrainConfig().batch_size] for a in train)
    for _ in range(3):
        probe.train_epoch(batch)
    wall, busy, ops, _ = profiled(lambda: [probe.train_epoch(batch) for _ in range(20)])
    out = {"examples": [split, len(qa_rows) - split], "prep_s": t_prep, "kernel_launches": launches,
           "epochs": results["epochs_trained"], "wall_s": results["wall_clock_seconds"],
           "epoch_s": results["wall_clock_seconds"] / results["epochs_trained"],
           "step_ms": results["wall_clock_seconds"] / steps * 1e3,
           "profiled_step_ms": wall / 20 * 1e3, "busy_step_ms": busy / 20 * 1e3,
           "ops_per_step": ops / 20, "idle_share": 1.0 - busy / wall,
           "val_hit_at_1": results["val_hit_at_1"], "first_loss": losses[0],
           "final_loss": losses[-1]}
    log(f"  router data: {split} + {len(qa_rows) - split} questions (nq.jsonl rows "
        f"{ROUTER_ROWS[0]}-{ROUTER_ROWS[1]}) scored in {t_prep:.3f} s, heap kernel launches "
        f"{launches}")
    log(f"  router training: {out['epochs']} epochs in {out['wall_s']:.2f} s = "
        f"{out['epoch_s']:.3f} s an epoch, {out['step_ms']:.3f} ms a step (validation and "
        f"checkpoints included); train loss {losses[0]:.4f} -> {losses[-1]:.4f}; val hit@1 "
        f"{out['val_hit_at_1']:.4f} (gate {MIN_ROUTER_HIT})")
    log(f"  router step under torch.profiler (B = 16): {out['profiled_step_ms']:.3f} ms on the "
        f"host clock, device busy {out['busy_step_ms']:.4f} ms in {out['ops_per_step']:.1f} "
        f"kernels and copies, idle share {out['idle_share']:.1%}")
    if not losses[-1] < losses[0] or out["val_hit_at_1"] < MIN_ROUTER_HIT:
        raise AssertionError(f"router: losses {losses[0]} -> {losses[-1]}, hit@1 "
                             f"{out['val_hit_at_1']}")
    if not same_state(router.module, reloaded.module) or reloaded.config != config:
        raise AssertionError("router: final_router.msgpack reloads to other weights")
    return out


def train_encoder_path(corpus, qa_rows, tmp: Path, device: str) -> dict:
    """cli/train_encoder.py on the card: random init at the demo encoder's
    configuration, 200 steps at batch 256, recall through the heap kernel."""
    config = EncoderConfig(dim=ENCODER_DIM, num_layers=2, num_heads=8, mlp_dim=1024,
                           max_seq_len=64, vocab_buckets=1 << 14)
    patch, trainers = instances(train_encoder_cli, "ContrastiveTrainer")
    ck.cuda_cosine_topk.launches = ck.cuda_cosine_topk.large_launches = 0
    with patch:
        results = train_encoder_cli.train_encoder(
            corpus, qa_rows, output_dir=str(tmp / "encoder"), encoder_config=config,
            train_config=EncoderTrainConfig(total_steps=ENCODER_STEPS, batch_size=256),
            device=device)
    launches = ck.cuda_cosine_topk.launches
    trainer = trainers[0]
    losses = np.asarray(trainer.losses)
    recall = results["dense_recall@10"]
    reloaded = load_encoder_checkpoint(str(tmp / "encoder/encoder.msgpack"), device=device)
    if reloaded.config != config or not same_state(trainer.model, reloaded.model):
        raise AssertionError("encoder.msgpack reloads to other weights")
    # The step alone: 21 more steps of fit, timed between the ends of steps
    # (each ends in a sync for its loss), so the hashing before them is out.
    stamps: list = []
    trainer.fit([q["question"] for q in qa_rows[:5120]], [q["context"] for q in qa_rows[:5120]],
                steps=21, log_every=0, on_step=lambda s, loss: stamps.append(time.perf_counter()))
    step_s = float(np.median(np.diff(stamps)))
    batch = trainer.encode_pairs([q["question"] for q in qa_rows[:256]],
                                 [q["context"] for q in qa_rows[:256]])
    wall, busy, ops, heavy = profiled(lambda: trainer.train_step(*batch), top=5)
    out = {"pairs": results["n_train_pairs"], "heldout": results["n_heldout"],
           "steps": results["steps"], "first20_loss": float(losses[:20].mean()),
           "last20_loss": float(losses[ENCODER_STEPS - 20 : ENCODER_STEPS].mean()),
           "recall_trained": recall["trained_encoder"],
           "recall_untrained": recall["untrained_encoder"], "recall_ngram": recall["ngram_hash"],
           "recall_sha256": recall["sha256_reference_fallback"], "kernel_launches": launches,
           "train_s": results["train_seconds"], "step_ms": step_s * 1e3,
           "pairs_per_s": 256 / step_s, "profiled_step_ms": wall * 1e3, "busy_ms": busy * 1e3,
           "ops_per_step": ops, "idle_share": 1.0 - busy / wall,
           "heaviest_ms": {name: t * 1e3 for name, t in heavy}}
    log(f"  encoder: {out['pairs']} training pairs, {out['heldout']} held-out questions; "
        f"{ENCODER_STEPS} steps at batch 256: mean loss of the first 20 {out['first20_loss']:.4f},"
        f" of the last 20 {out['last20_loss']:.4f}")
    log(f"  encoder recall@10 (heap kernel, launches {launches}): trained "
        f"{out['recall_trained']:.4f}, untrained {out['recall_untrained']:.4f}, ngram_hash "
        f"{out['recall_ngram']:.4f}, sha256 {out['recall_sha256']:.4f}")
    log(f"  encoder step: median {out['step_ms']:.3f} ms = {out['pairs_per_s']:.1f} pairs/s "
        f"(20 steps of fit, batch selection included); train_encoder's training span "
        f"{out['train_s']} s (hashing and the untrained recall included)")
    log(f"  encoder step under torch.profiler: {out['profiled_step_ms']:.3f} ms on the host "
        f"clock, device busy {out['busy_ms']:.3f} ms in {ops} kernels and copies, idle share "
        f"{out['idle_share']:.1%}; heaviest kernels (ms): "
        f"{[(n, round(t, 3)) for n, t in out['heaviest_ms'].items()]}")
    if not out["last20_loss"] < out["first20_loss"] or launches < 1:
        raise AssertionError(f"encoder losses {out['first20_loss']} -> {out['last20_loss']}")
    if not out["recall_trained"] > out["recall_untrained"]:
        raise AssertionError(f"encoder recall trained {out['recall_trained']} <= untrained "
                             f"{out['recall_untrained']}")
    return out


def lm_step_flop(cfg) -> float:
    """The operations of one TinyLM training step (forward and backward) at
    batch LM_BATCH and sequence LM_SEQ: 6 per weight of every product per
    token, and the attention's two products (2 B H L^2 Dh each) times 3."""
    d, f = cfg.dim, cfg.mlp_dim
    weights = cfg.num_layers * (4 * d * d + 2 * d * f) + d * 258
    tokens = LM_BATCH * LM_SEQ
    attention = cfg.num_layers * 2 * (2 * LM_BATCH * LM_SEQ * LM_SEQ * d) * 3
    return 6.0 * weights * tokens + attention


def train_lm_path(qa_rows, corpus_texts, fixture, tmp: Path, device: str) -> dict:
    """TinyLMTrainer on the card at models/tiny_lm_r5's full recipe, warm
    started from it; then a small cli/train_lm.py run."""
    meta = json.loads(Path(str(DEMO_LM) + ".json").read_text())
    model_cfg = TinyLMConfig(**meta["model_config"])
    trainer = TinyLMTrainer(model_cfg, LMTrainConfig(
        learning_rate=LM_LR, warmup_steps=1, total_steps=meta["train_config"]["total_steps"],
        batch_size=LM_BATCH, seq_len=LM_SEQ), device=device)
    trainer.load_params(load_flax_checkpoint(str(DEMO_LM)))
    data, masks = encode_qa_examples(qa_rows, LM_SEQ, seed=0, distractor_texts=corpus_texts,
                                     min_distractors=1, max_distractors=3)
    batch, mask = data[:LM_BATCH], masks[:LM_BATCH]

    # The training forward against the serving (KV-cached) forward at step 0.
    sampler = trainer.export_sampler()
    diffs, same = [], 0
    with torch.no_grad():
        for row in range(LM_CHECK_ROWS):
            last = int(np.flatnonzero(mask[row])[0])  # the last prompt position
            tok = torch.from_numpy(batch[row : row + 1, : last + 1]).to(device)
            full = trainer.model(tok)[0, -1]
            cache = sampler.model.init_cache(1)
            sampler.model(tok[:, :-1], cache, logits=False)
            cached = sampler.model(tok[:, -1:], cache)[0, -1]
            diffs.append(float((full - cached).abs().mean()))
            same += int(full.argmax() == cached.argmax())
    log(f"  TinyLM training forward vs KV-cached decode at the last prompt position of "
        f"{LM_CHECK_ROWS} rows: mean |logit diff| {np.mean(diffs):.5f} (max over rows "
        f"{max(diffs):.5f}), argmax equal {same}/{LM_CHECK_ROWS}")
    if np.mean(diffs) >= LM_LOGIT_BOUND or same < 0.9 * LM_CHECK_ROWS:
        raise AssertionError(f"TinyLM training forward vs decode: {np.mean(diffs)}, {same}")

    flop = lm_step_flop(model_cfg)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(LM_STEPS + 1):
        loss, t = timed(lambda: trainer.train_step(batch, mask))
        losses.append(loss)
        times.append(t)
        if step == 0 and not all(torch.equal(a, b) for a, b in zip(before, trainer.model.parameters())):
            raise AssertionError("TinyLM step 1 (learning rate 0) moved the parameters")
    peak = torch.cuda.max_memory_allocated()
    wall, busy, ops, heavy = profiled(lambda: trainer.train_step(batch, mask), top=8)
    step_s = float(np.median(times[1:]))
    out = {"losses": [losses[0], losses[-1]], "step_ms": step_s * 1e3,
           "first_step_ms": times[0] * 1e3, "tokens_per_s": LM_BATCH * LM_SEQ / step_s,
           "step_tflop": flop / 1e12, "tflop_per_s": flop / step_s / 1e12,
           "bound_ms": flop / PEAK_BF16_FLOPS * 1e3, "peak_memory_gib": peak / 2**30,
           "profiled_step_ms": wall * 1e3, "busy_ms": busy * 1e3, "ops_per_step": ops,
           "idle_share": 1.0 - busy / wall,
           "heaviest_ms": {name: t * 1e3 for name, t in heavy}}
    log(f"  TinyLM fine-tune ({model_cfg.dim}-d, {model_cfg.num_layers} layers, batch "
        f"{LM_BATCH} x {LM_SEQ}, one fixed batch, warmup 1, lr {LM_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} in {LM_STEPS} steps; step 1 left the parameters "
        f"as they were")
    log(f"  TinyLM step: median {out['step_ms']:.2f} ms (first {out['first_step_ms']:.2f}) = "
        f"{out['tokens_per_s']:.0f} tokens/s; {out['step_tflop']:.3f} TFLOP counted a step = "
        f"{out['tflop_per_s']:.1f} TFLOP/s ({out['tflop_per_s'] * 1e12 / PEAK_BF16_FLOPS:.1%} "
        f"of the bf16 peak, bound {out['bound_ms']:.2f} ms); peak memory "
        f"{out['peak_memory_gib']:.2f} GiB")
    log(f"  TinyLM step under torch.profiler: {out['profiled_step_ms']:.2f} ms on the host "
        f"clock, device busy {out['busy_ms']:.2f} ms in {ops} kernels and copies, idle share "
        f"{out['idle_share']:.1%}; heaviest kernels (ms): "
        f"{[(n, round(t, 2)) for n, t in out['heaviest_ms'].items()]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"TinyLM: {LM_STEPS} steps on one batch did not lower its loss")

    qa_losses = trainer.fit_qa(qa_rows[:LM_BATCH * 4], steps=2, seq_len=LM_SEQ)
    lm = trainer.export_sampler()
    prompts = [build_qa_prompt(q, c) for q, c in
               zip(fixture["questions"][:4], fixture["contexts"][:4])]
    answers = lm.generate_batch(prompts, [0.1] * 4, [1e-6] * 4, max_tokens=fixture["max_tokens"])
    trainer.save_checkpoint(str(tmp / "lm/tiny_lm.msgpack"))
    reloaded = load_lm_checkpoint(str(tmp / "lm/tiny_lm.msgpack"), device=device)
    if len(answers) != 4 or not all(isinstance(a, str) for a in answers) or not np.isfinite(qa_losses).all():
        raise AssertionError(f"TinyLM after fine-tuning: {answers} {qa_losses}")
    if not same_state(lm.model, reloaded.model):
        raise AssertionError("TinyLM checkpoint reloads to other weights")
    log(f"  TinyLM fit_qa 2 steps (losses {qa_losses[-2]:.4f}, {qa_losses[-1]:.4f}); the "
        f"exported sampler answers the fixture's first 4 prompts {answers}; the checkpoint "
        f"reloads to the same weights")

    # cli/train_lm.py end to end at a small size (one world, a few steps).
    results, t_cli = timed(lambda: train_lm_cli.train_extractor(
        output_dir=str(tmp / "lm_cli"), n_worlds=1, articles_per_world=60, steps=3,
        batch_size=4, seq_len=256, dim=64, num_layers=1, eval_n=8, device=device))
    if results["steps"] != 3 or not 0.0 <= results["unseen_world_eval"]["exact_match"] <= 1.0:
        raise AssertionError(f"train_extractor: {results}")
    log(f"  cli/train_lm.py train_extractor (1 world, 3 steps, 64-d): {t_cli:.2f} s")
    out["peak_memory_bytes"] = peak
    return out


def phase_train(fixture, device: str = "cuda") -> dict:
    """The training path on the card: the heap kernel at the router data
    path's shape, then router, encoder and TinyLM training through the
    port's trainers and cli/train_* functions. (``device`` is "cuda" in
    every run of this script.)"""
    encoder = load_encoder_checkpoint(str(DEMO_ENCODER), device=device)
    corpus = read_jsonl(RUN / "corpus.jsonl")
    retriever = build_demo_index(encoder, corpus, device)
    qa = read_jsonl(RUN / "nq.jsonl")
    router_rows = qa[ROUTER_ROWS[0] : ROUTER_ROWS[1]]

    index = retriever.dense_index
    q = index.embed_queries([r["question"] for r in router_rows[:ROUTER_DATA_BATCH]])
    kv, ki = ck.cuda_cosine_topk(index._emb, q, len(index), POOL)
    pv, pi = ck.cosine_topk_plain(index._emb, q, len(index), POOL)
    err = check_topk(kv, ki, pv, pi, f"train path B={len(q)} k={POOL} over {len(index)} live "
                     f"rows D={ENCODER_DIM}", KERNEL_ATOL,
                     lambda ids: torch.matmul(q[ids].to(index._emb.dtype).float(),
                                              index._emb[: len(index)].float().T))
    size, emb = len(index), index._emb
    ms = cuda_ms(lambda: ck.cuda_cosine_topk(emb, q, size, POOL), reps=50)
    plain_ms = cuda_ms(lambda: ck.cosine_topk_plain(emb, q, size, POOL), reps=5)
    q16 = q.to(emb.dtype)
    library_ms = cuda_ms(lambda: torch.topk(torch.matmul(q16, emb[:size].T), POOL), reps=50)
    t_ops = 2.0 * len(q) * size * ENCODER_DIM / PEAK_BF16_FLOPS * 1e3
    t_bytes = (size * ENCODER_DIM * 2 + q.numel() * 4 + len(q) * POOL * 8) / PEAK_BYTES_S * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"  heap kernel at the router data path's shape (B = {len(q)}, k = {POOL}, "
        f"{size} live D = {ENCODER_DIM} rows): max_abs_err {err:.3g}, tie-aware agreement 1.0; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    with tempfile.TemporaryDirectory() as tmp:
        router = train_router_path(retriever, router_rows, Path(tmp), device)
        del retriever, encoder, index, q
        torch.cuda.empty_cache()
        enc = train_encoder_path(corpus, qa, Path(tmp), device)
        torch.cuda.empty_cache()
        lm = train_lm_path(qa, [r["text"] for r in corpus], fixture, Path(tmp), device)
    torch.cuda.empty_cache()
    return {"kernel_max_abs_err": err, "kernel_timing": timing, "router": router, "encoder": enc,
            "tiny_lm": lm}


def flat_items(tree: dict, prefix: str = ""):
    """(dotted key, value) for every leaf of nested dicts, in order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat_items(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


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
    with phase("large_k"):
        large_row = phase_kernel_large(gen)
    torch.cuda.empty_cache()
    with phase("slice"):
        ctx = phase_slice(args.seed, device["name"])
    with phase("twotier"):
        twotier_launches = phase_twotier(ctx)
    with phase("ingest"):
        ingest_launches = phase_ingest(ctx)
    with phase("persist"):
        persist_launches, large_launches = phase_persist(ctx)
    with phase("answer"):
        answer = phase_answer()
    torch.cuda.empty_cache()
    with phase("train"):
        train = phase_train(json.loads(FIXTURE.read_text()))
    for key, value in flat_items(train):
        log(f"train {key} {value}")
    faulthandler.cancel_dump_traceback_later()
    row["launches"] = ctx["launches"]
    row["launches_by_path"] = {"scatter": ctx["launches"], "twotier": twotier_launches,
                               "ingest": ingest_launches, "persist_http": persist_launches,
                               "answer": answer["launches"],
                               "answer_recall": answer["recall_launches"],
                               "train_router_data": train["router"]["kernel_launches"],
                               "train_encoder_recall": train["encoder"]["kernel_launches"]}
    row["answer_phase"] = {k: v for k, v in answer.items() if "launches" not in k}
    row["train_phase"] = train
    large_row["launches"] = large_launches  # the persist path's k = 1000 searches
    row["bm25_pool_s"] = {"scatter": ctx["scatter_pool_s"], "twotier": ctx["twotier_pool_s"]}
    print(json.dumps({"kernels": [row, large_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
