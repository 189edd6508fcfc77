"""Batched retrieval serving: the counterpart of ``rag_uq_tpu/cli/serve.py::QueryService``.

A micro-batching loop aggregates concurrent requests into one fused device
query per tick. Ported here: the request queue, the batching loop
(``_loop``, ``_dispatch_loop``, ``_run_batch``), ``search`` and ``ingest``.
``serve_http``, ``/answer`` and the CLI ``main`` wait for a later slice.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter

logger = logging.getLogger(__name__)


@dataclass
class _Pending:
    """A queued operation: a search batch, or (documents != None) an ingest."""

    queries: List[str]
    k: int
    documents: Optional[List[Any]] = None
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Any] = None
    error: Optional[BaseException] = None
    # Stamped at submit; _run_batch accumulates dispatch - submit into the
    # queue-wait stat (the batching delay component of serving latency).
    t_submit: float = 0.0


class QueryService:
    """Micro-batching search engine: requests aggregate into device batches.

    Serving uses the scatter-mode BM25 pool op (sparse_mode="scatter",
    ops/bm25.topk_lowscatter); "twotier" waits for the next slice.
    """

    def __init__(
        self,
        retriever: HybridRetriever,
        router: Optional[RetrievalRouter] = None,
        max_batch: int = 256,
        tick_ms: float = 2.0,
        sparse_mode: str = "scatter",
        retrieval_pool_size: int = 50,
        dispatch_workers: int = 4,
    ):
        self.retriever = retriever
        self.router = router
        self.sparse_mode = sparse_mode
        self.max_batch = max_batch
        self.tick_s = tick_ms / 1000.0
        self.pool_size = retrieval_pool_size
        # hybrid_search_batch caps k at 2*pool; clamp at the service layer so
        # oversized/invalid k from a payload can't silently truncate or fail
        # a whole co-batched query (a top-k wider than the pool).
        self.max_k = 2 * retrieval_pool_size
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # Pipelined dispatch: the aggregator forms batches and N dispatcher
        # threads keep that many in flight, so one batch's host work
        # (encoding, result assembly) overlaps another's device work.
        # Ingest serializes against all in-flight searches (see _loop),
        # preserving ingest-then-search visibility order.
        self._work: "queue.Queue[List[_Pending]]" = queue.Queue(
            maxsize=max(2 * dispatch_workers, 2)
        )
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # Aggregate counters: batches formed, queries served, seconds spent
        # inside the search call, and the queue wait of the requests.
        self.stats = {
            "batches": 0, "queries": 0, "call_seconds": 0.0,
            "queue_wait_seconds": 0.0,
        }
        self._stats_lock = threading.Lock()
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop, daemon=True)
            for _ in range(max(dispatch_workers, 1))
        ]
        for t in self._dispatchers:
            t.start()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        for t in self._dispatchers:
            t.join(timeout=5)
        # Release any requests still queued so callers never hang.
        pending: List[_Pending] = []
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        while True:
            try:
                pending.extend(self._work.get_nowait())
            except queue.Empty:
                break
        for req in pending:
            req.result = {} if req.documents is not None else [
                [] for _ in req.queries
            ]
            req.event.set()

    def _submit(self, req: _Pending):
        if self._stop.is_set():
            raise RuntimeError("QueryService is closed")
        req.t_submit = time.time()
        self._queue.put(req)
        # Bounded waits so a dead worker surfaces as an error, not a hang.
        while not req.event.wait(timeout=1.0):
            if not self._worker.is_alive() or self._stop.is_set():
                if req.event.is_set():
                    break
                raise RuntimeError("QueryService worker stopped")
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    def ingest(self, documents) -> Dict[str, int]:
        """Add documents live, serialized onto the worker thread — all index
        mutation and lazy device-state rebuilds happen on one thread, so
        concurrent /ingest and /search requests can never tear the host
        buffers mid-sync. The next batch's state rebuild is delta-synced
        when bm25.delta_sync_fraction > 0."""
        return self._submit(_Pending(queries=[], k=0, documents=list(documents)))

    def search(self, queries: List[str], k: int = 10) -> List[List[Dict[str, Any]]]:
        k = max(1, min(int(k), self.max_k))
        return self._submit(_Pending(queries=queries, k=k))

    # -- batching loop -----------------------------------------------------------

    def _loop(self) -> None:
        carry: Optional[_Pending] = None
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=self.tick_s)
                except queue.Empty:
                    continue
            if first.documents is not None:
                # Barrier: wait for every in-flight search, mutate, then
                # rebuild the device state on THIS thread before dispatchers
                # resume — no search can observe a half-built sync. Re-check
                # _stop each wait: a wedged device call would otherwise pin
                # this thread (and the unreleased _Pending) forever after
                # close().
                with self._inflight_cv:
                    while self._inflight > 0 and not self._stop.is_set():
                        self._inflight_cv.wait(timeout=1.0)
                if self._stop.is_set():
                    first.result = {}
                    first.event.set()
                    break
                self._run_ingest(first)
                try:
                    self.retriever._fused_state()
                except Exception:  # pragma: no cover
                    # Next search resyncs lazily; _fused_state's internal
                    # lock serializes that rebuild across dispatcher threads
                    # (advisor r3: concurrent lazy resyncs could tear the
                    # host/device buffers).
                    pass
                continue
            batch = [first]
            n = len(first.queries)
            # Aggregate whatever arrived within the tick window. An ingest
            # op ends the window (carried to the next iteration) so queue
            # order — ingest-then-search sees the new docs — is preserved.
            deadline_passed = False
            while n < self.max_batch and not deadline_passed:
                try:
                    nxt = self._queue.get(timeout=self.tick_s)
                    if nxt.documents is not None:
                        carry = nxt
                        break
                    batch.append(nxt)
                    n += len(nxt.queries)
                except queue.Empty:
                    deadline_passed = True
            with self._inflight_cv:
                self._inflight += 1
            # Bounded put with _stop re-checks (the bounded _work queue can
            # stay full indefinitely if dispatchers wedge on the device).
            placed = False
            while not self._stop.is_set():
                try:
                    self._work.put(batch, timeout=1.0)
                    placed = True
                    break
                except queue.Full:
                    continue
            if not placed:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()
                for req in batch:
                    req.result = [[] for _ in req.queries]
                    req.event.set()
                break
        if carry is not None:
            carry.result = {}
            carry.event.set()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._work.get(timeout=self.tick_s)
            except queue.Empty:
                continue
            try:
                self._run_batch(batch)
            finally:
                with self._inflight_cv:
                    self._inflight -= 1
                    self._inflight_cv.notify_all()

    def _run_ingest(self, req: _Pending) -> None:
        try:
            req.result = self.retriever.add_documents(req.documents)
        except Exception as e:  # pragma: no cover - serving resilience
            logger.exception("ingest failed: %s", e)
            req.error = e
            req.result = {}
        req.event.set()

    def reset_stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self.stats)
            self.stats = {
                "batches": 0, "queries": 0, "call_seconds": 0.0,
                "queue_wait_seconds": 0.0,
            }
        return out

    def _run_batch(self, batch: List[_Pending]) -> None:
        import time as _time

        all_queries: List[str] = []
        for req in batch:
            all_queries.extend(req.queries)
        k = max(req.k for req in batch)
        try:
            t0 = _time.time()
            # Per-request batching delay: submit -> device dispatch.
            qwait = sum(
                (t0 - req.t_submit) * len(req.queries)
                for req in batch if req.t_submit
            )
            vals, pos = self.retriever.hybrid_search_batch(
                all_queries, top_k=k, router=self.router,
                sparse_mode=self.sparse_mode,
            )
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["queries"] += len(all_queries)
                self.stats["call_seconds"] += _time.time() - t0
                self.stats["queue_wait_seconds"] += qwait
            store = self.retriever.documents
            results: List[List[Dict[str, Any]]] = []
            for row_v, row_p in zip(vals, pos):
                hits = []
                for score, p in zip(row_v, row_p):
                    if p >= 0:
                        hits.append(
                            {
                                "doc_id": store.ids[int(p)],
                                "score": float(score),
                                "text": store.texts[int(p)],
                            }
                        )
                results.append(hits)
        except Exception as e:  # pragma: no cover - serving resilience
            logger.exception("batch failed: %s", e)
            results = [[] for _ in all_queries]

        offset = 0
        for req in batch:
            req.result = [
                hits[: req.k] for hits in results[offset : offset + len(req.queries)]
            ]
            offset += len(req.queries)
            req.event.set()
