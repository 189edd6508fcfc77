"""Serving-layer benchmark: the counterpart of ``rag_uq_tpu/cli/bench_serving.py``.

Closed-loop clients against ``QueryService``: what ``cli/serve.py``
delivers, tail latency and throughput through the micro-batching worker,
as opposed to a timing of the fused query alone. The reference has no
serving layer at all (its deployment is docker-compose around
Ollama/ChromaDB), so these numbers are framework capability, not parity.

Protocol: build a synthetic corpus at --n-docs, start a QueryService
(scatter-mode BM25 pool, the serving default), then run closed-loop client
threads for --seconds at each --concurrency level: every client submits
one random single-query search (k=10) and blocks for its result. Reported
per level: achieved QPS, latency p50/p95/p99, the mean device batch the
micro-batcher formed, the mean time a batch spends inside the search call,
the calls in flight on average and the mean queue wait a request.

Before the levels, every power-of-two batch the micro-batcher can form
(1 to 256) runs once, so the levels measure steady serving: on the card
that first pass also builds the kernels with ``nvcc`` and grows the
caching allocator. The artifact carries the card's name and power limit.

    python3 -m rag_uq_tpu_torch.cli.bench_serving [--device cpu]

Writes one JSON artifact (default runs/serving_torch/serving_bench.json)
and prints it.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

logger = logging.getLogger(__name__)


def _build_corpus(n_docs: int, seed: int = 0):
    """Synthetic token-id passages (Zipf 1.07 over a 30k vocabulary)."""
    from rag_uq_tpu_torch.core.types import Document

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(30_000)]
    probs = 1.0 / np.arange(1, len(vocab) + 1) ** 1.07
    probs /= probs.sum()
    docs = []
    for d in range(n_docs):
        n_tok = int(rng.integers(40, 120))
        toks = rng.choice(len(vocab), size=n_tok, p=probs)
        docs.append(
            Document(id=f"doc{d}", text=" ".join(vocab[t] for t in toks))
        )
    return docs


def _percentiles(lat_ms: List[float]):
    a = np.asarray(lat_ms)
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 2),
        "p95_ms": round(float(np.percentile(a, 95)), 2),
        "p99_ms": round(float(np.percentile(a, 99)), 2),
        "mean_ms": round(float(a.mean()), 2),
    }


def run_level(service, queries: List[str], concurrency: int,
              seconds: float, seed: int = 0):
    """Closed-loop clients; returns latency/QPS stats for one level."""
    stop = time.time() + seconds
    lats: List[List[float]] = [[] for _ in range(concurrency)]
    errors = [0] * concurrency

    def client(ci: int):
        rng = np.random.default_rng(seed + ci)
        while time.time() < stop:
            q = queries[int(rng.integers(0, len(queries)))]
            t0 = time.time()
            try:
                service.search([q], k=10)
            except Exception:
                errors[ci] += 1
                continue
            lats[ci].append((time.time() - t0) * 1000.0)

    service.reset_stats()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(concurrency)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    stats = service.reset_stats()
    flat = [x for row in lats for x in row]
    out = {
        "concurrency": concurrency,
        "requests": len(flat),
        "errors": sum(errors),
        "qps": round(len(flat) / wall, 1),
        **_percentiles(flat),
    }
    if stats["batches"]:
        # Mean synchronous search-call time per batch (host encoding, the
        # fused query on the device, the copy back), the mean formed
        # batch, the calls in flight on average, and the mean per-request
        # queue wait (submit -> dispatch): together with the artifact's
        # round-trip floor they decompose client latency into queue +
        # call.
        out["device_batches"] = stats["batches"]
        out["mean_batch_size"] = round(stats["queries"] / stats["batches"], 1)
        out["mean_call_ms"] = round(
            1000.0 * stats["call_seconds"] / stats["batches"], 1
        )
        out["call_concurrency"] = round(stats["call_seconds"] / wall, 2)
        if stats["queries"]:
            out["mean_queue_wait_ms"] = round(
                1000.0 * stats.get("queue_wait_seconds", 0.0)
                / stats["queries"], 1
            )
    return out


def measure_relay_rtt(n: int = 20, device: str = "cuda") -> dict:
    """Floor of one synchronous device -> host round trip: ``.item()`` of
    one element of a tensor already materialised on ``device``, n times.

    On the H100 this is the card's own floor, a stream synchronise and a
    4-byte copy to the host; there is no relay in the path. The key names
    are the JAX package's. On the CPU it measures a host read.
    """
    import torch

    from rag_uq_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    x = torch.arange(8.0, device=dev)
    x[0].item()  # materialise + first-transfer warm-up
    ts = []
    for _ in range(n):
        t0 = time.time()
        x[0].item()
        ts.append((time.time() - t0) * 1000.0)
    a = np.asarray(ts)
    return {
        "relay_rtt_floor_ms_p50": round(float(np.percentile(a, 50)), 3),
        "relay_rtt_floor_ms_mean": round(float(a.mean()), 3),
        "n_probes": n,
    }


def sample_queries(docs, n: int = 2048, seed: int = 1) -> List[str]:
    """Random 5-term samples from the documents, so the BM25 side has
    matching postings."""
    rng = np.random.default_rng(seed)
    queries = []
    for _ in range(n):
        toks = docs[int(rng.integers(0, len(docs)))].text.split()
        s = int(rng.integers(0, max(1, len(toks) - 5)))
        queries.append(" ".join(toks[s:s + 5]))
    return queries


def warm_buckets(retriever, queries: List[str]) -> None:
    """One search at every power-of-two batch from 1 to 256."""
    b = 1
    while b <= 256:
        retriever.hybrid_search_batch(queries[:b], top_k=10,
                                      sparse_mode="scatter")
        b *= 2


def run_bench(n_docs: int = 20_000, seconds: float = 15.0,
              concurrency=(1, 8, 32, 128), tick_ms: float = 2.0,
              dispatch_workers: int = 4, device: str = "cuda",
              before_level=None):
    """The whole protocol: corpus, index, warm-up, round-trip floor, then a
    QueryService under each concurrency level. ``before_level(service, c)``,
    if given, runs just before level ``c``, after the service's own warm-up.
    Returns (the artifact's dict, the retriever, the query list)."""
    from rag_uq_tpu_torch.cli.serve import QueryService
    from rag_uq_tpu_torch.core.device import card_info, resolve_device
    from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

    dev = resolve_device(device)
    t0 = time.time()
    docs = _build_corpus(n_docs)
    retriever = HybridRetriever(device=dev)
    retriever.add_documents(docs)
    build_s = time.time() - t0
    logger.info("indexed %d docs in %.1fs", n_docs, build_s)

    queries = sample_queries(docs)
    t0 = time.time()
    warm_buckets(retriever, queries)
    logger.info("bucket warmup in %.1fs", time.time() - t0)

    rtt = measure_relay_rtt(device=dev)
    logger.info("device round-trip floor: %s", rtt)

    service = QueryService(retriever, tick_ms=tick_ms,
                           dispatch_workers=dispatch_workers)
    levels = []
    try:
        service.search(queries[:8], k=10)  # worker-path warmup
        for c in concurrency:
            if before_level is not None:
                before_level(service, c)
            levels.append(run_level(service, queries, c, seconds))
    finally:
        service.close()

    result = {
        "n_docs": n_docs,
        "index_build_seconds": round(build_s, 1),
        "tick_ms": tick_ms,
        "dispatch_workers": dispatch_workers,
        "seconds_per_level": seconds,
        **rtt,
        "levels": levels,
        **card_info(dev),
    }
    return result, retriever, queries


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-docs", type=int, default=20_000)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--concurrency", type=int, nargs="+",
                        default=[1, 8, 32, 128])
    parser.add_argument("--out", default="runs/serving_torch/serving_bench.json")
    parser.add_argument("--tick-ms", type=float, default=2.0)
    parser.add_argument("--dispatch-workers", type=int, default=4,
                        help="search calls in flight: one batch's host work "
                        "(encoding, result assembly) overlaps another's "
                        "device work")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    result, _, _ = run_bench(args.n_docs, args.seconds, args.concurrency,
                             args.tick_ms, args.dispatch_workers, args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
