"""The port's serving bench (``cli/bench_serving.py``) against the JAX
package's, on the CPU, and the kernel's launch counts under threads.

- ``_build_corpus`` gives the JAX function's documents for a seed, and
  ``_percentiles`` its numbers for one list (exact);
- ``run_level`` at concurrency 2 for 1 s has every key and inequality of
  the JAX test (``tests/test_cli.py::TestBenchServing``), and answers served
  under concurrency equal a direct ``hybrid_search_batch`` of the same query
  under the tie rule (``cli/bench_sharded.py::tie_aware_agreement`` at its
  defaults, rtol 1e-5, atol 1e-6);
- ``main`` writes an artifact with the JAX artifact's keys
  (``runs/serving_bench.json``, written by the JAX ``main``) plus the card's
  name and power limit, and raises without a card unless ``--device cpu``;
- ``run_bench``, which ``main`` and ``chip_smoke.py`` share, calls its
  ``before_level`` hook once before each level, on the running service;
- ``ops/cosine_topk.py::record_launch`` keeps every count when many threads
  launch at once.
"""

import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.cli import bench_serving as jax_bench  # noqa: E402
from rag_uq_tpu_torch.cli import bench_serving as bench  # noqa: E402
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement  # noqa: E402
from rag_uq_tpu_torch.cli.serve import QueryService  # noqa: E402
from rag_uq_tpu_torch.core.config import DenseIndexConfig  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.ops import cosine_topk as ck  # noqa: E402
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JAX_ARTIFACT = REPO / "runs" / "serving_bench.json"
CARD_KEYS = {"device_name", "power_limit"}


@pytest.fixture(scope="module")
def small_index():
    docs = bench._build_corpus(240, seed=3)
    retriever = HybridRetriever(
        embedder=NgramHashEmbedder(dim=64, buckets=4096, device="cpu"),
        dense_config=DenseIndexConfig(embedding_dim=64, initial_capacity=256),
        device="cpu",
    )
    retriever.add_documents(docs)
    return retriever, bench.sample_queries(docs, n=64)


def test_build_corpus_matches_jax():
    ours, theirs = bench._build_corpus(60, seed=5), jax_bench._build_corpus(60, seed=5)
    assert [(d.id, d.text, d.title) for d in ours] == [(d.id, d.text, d.title) for d in theirs]


def test_percentiles_match_jax():
    lat = list(np.random.default_rng(0).exponential(5.0, size=257))
    assert bench._percentiles(lat) == jax_bench._percentiles(lat)


def test_run_level_smoke(small_index):
    retriever, queries = small_index
    service = QueryService(retriever, max_batch=8, tick_ms=1.0)
    try:
        stats = bench.run_level(service, queries[:2], concurrency=2, seconds=1.0)
    finally:
        service.close()
    assert stats["errors"] == 0
    assert stats["requests"] > 0
    assert stats["qps"] > 0
    assert stats["p50_ms"] <= stats["p99_ms"]
    assert stats["device_batches"] > 0
    assert stats["mean_batch_size"] >= 1.0
    assert stats["mean_call_ms"] > 0
    assert stats["call_concurrency"] >= 0
    assert stats["mean_queue_wait_ms"] >= 0
    level_keys = set(json.loads(JAX_ARTIFACT.read_text())["levels"][0])
    assert set(stats) == level_keys


def test_served_answers_equal_direct_searches(small_index):
    """Answers from four closed-loop clients, recorded by a wrapper around
    ``service.search``, against one direct search of each query."""
    retriever, queries = small_index
    service = QueryService(retriever, tick_ms=2.0, dispatch_workers=4)
    served, lock = [], threading.Lock()
    search = service.search

    def recorded(qs, k=10):
        hits = search(qs, k=k)
        with lock:
            served.append((qs[0], hits[0]))
        return hits

    service.search = recorded
    try:
        level = bench.run_level(service, queries, concurrency=4, seconds=1.0)
    finally:
        service.close()
    assert level["errors"] == 0 and len(served) == level["requests"] >= 8
    assert level["mean_batch_size"] > 1.0  # the clients' requests were co-batched
    pos_of = {doc_id: i for i, doc_id in enumerate(retriever.documents.ids)}
    qs = [q for q, _ in served]
    dv, dp = retriever.hybrid_search_batch(qs, top_k=10, sparse_mode="scatter")
    assert all(hits for _, hits in served)
    sv = np.full(dv.shape, -np.inf, dtype=np.float32)
    sp = np.full(dp.shape, -1, dtype=np.int32)
    for i, (_, hits) in enumerate(served):
        sv[i, : len(hits)] = [h["score"] for h in hits]
        sp[i, : len(hits)] = [pos_of[h["doc_id"]] for h in hits]
    dv = np.where(dp >= 0, dv, -np.inf)
    agree = tie_aware_agreement(sv, sp, dv, dp)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"][:2]


def test_measure_relay_rtt():
    rtt = bench.measure_relay_rtt(n=3, device="cpu")
    assert set(rtt) == {"relay_rtt_floor_ms_p50", "relay_rtt_floor_ms_mean", "n_probes"}
    assert rtt["n_probes"] == 3
    assert rtt["relay_rtt_floor_ms_p50"] >= 0


def test_main_writes_the_jax_artifact_keys(tmp_path, capsys):
    out = tmp_path / "serving_bench.json"
    bench.main(["--device", "cpu", "--n-docs", "300", "--seconds", "0.5",
                "--concurrency", "1", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    ref = json.loads(JAX_ARTIFACT.read_text())
    assert set(got) == set(ref) | CARD_KEYS
    assert got["device_name"] == "cpu" and got["power_limit"] is None
    assert [lv["concurrency"] for lv in got["levels"]] == [1, 2]
    for level in got["levels"]:
        assert set(level) == set(ref["levels"][0]) and level["errors"] == 0


def test_run_bench_calls_before_level_once_a_level():
    seen = []

    def before_level(service, c):
        assert isinstance(service, QueryService)
        seen.append((c, service.reset_stats()["batches"]))

    result, retriever, queries = bench.run_bench(
        n_docs=200, seconds=0.3, concurrency=(1, 2), device="cpu", before_level=before_level)
    assert [c for c, _ in seen] == [1, 2]
    assert seen[0][1] >= 1  # the service's own warm-up came before the first level
    assert [lv["concurrency"] for lv in result["levels"]] == [1, 2]
    assert len(retriever) == 200 and queries == bench.sample_queries(bench._build_corpus(200))


def test_main_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--n-docs", "10"])


class YieldingCounts:
    """A stand-in for the wrapper's count attributes whose every read gives
    up the interpreter lock, as a launch between the read and the write
    would: an unlocked ``+= 1`` then loses counts."""

    def __init__(self):
        self._counts = {"launches": 0, "large_launches": 0}

    def _get(name):
        def read(self):
            value = self._counts[name]
            time.sleep(0)
            return value

        def write(self, value):
            self._counts[name] = value

        return property(read, write)

    launches = _get("launches")
    large_launches = _get("large_launches")


def test_launch_counts_survive_threads(monkeypatch):
    """Sixteen threads (more than the cores) each record 500 launches
    through ``record_launch``, with the interpreter switching threads every
    microsecond and the counts patched to yield on every read: no count may
    be lost."""
    counts = YieldingCounts()
    monkeypatch.setattr(ck, "cuda_cosine_topk", counts)
    n_threads, per_thread = 16, 500

    def worker(t: int) -> None:
        for i in range(per_thread):
            ck.record_launch(large=(i + t) % 4 == 0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert counts.launches == n_threads * per_thread
    assert counts.large_launches == n_threads * per_thread // 4
