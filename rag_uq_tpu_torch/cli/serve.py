"""Batched retrieval serving: the counterpart of ``rag_uq_tpu/cli/serve.py``.

A micro-batching loop aggregates concurrent requests into one fused device
query per tick (``QueryService``), behind a stdlib HTTP front end
(``serve_http``):

- ``GET /healthz``: status and document count;
- ``POST /search`` {"queries": [...], "k": N}: hits per query;
- ``POST /ingest`` {"documents": [{"id", "text", ...}, ...]}: live ingest,
  delta-synced when ``bm25.delta_sync_fraction > 0``;
- ``POST /answer`` {"question": ..., "k": N, "context_passages": n,
  "context_policy": "concat" | "per_passage"}: with a generator, the
  ``concat`` policy answers from the top-n passages joined and clipped to
  2,000 characters, and ``per_passage`` generates once per passage over at
  least 3 and keeps the best (``cli/evaluate.py``); without one, the top
  passage is the answer. The confidence is the length-ratio heuristic of
  ``uq/conformal.py`` against the context.

``main`` takes the JAX server's defaults: the trained encoder
``models/encoder/encoder.msgpack`` on the dense side and TinyLM
``models/tiny_lm/tiny_lm.msgpack`` for ``/answer``; a default path that
does not exist means "not used", and an empty string turns one off.

    python3 -m rag_uq_tpu_torch.cli.serve --bm25-path data/bm25_index.json \
        --dense-dir data/dense_index --port 8080 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

from rag_uq_tpu_torch.cli.evaluate import generate_answer, generate_answer_per_passage
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.embed.train import load_encoder_checkpoint
from rag_uq_tpu_torch.llm.train import load_lm_checkpoint
from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.train import load_router_checkpoint
from rag_uq_tpu_torch.uq.conformal import ConformalRAG

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

    Serving defaults to the scatter-mode BM25 pool op (sparse_mode="scatter",
    ops/bm25.topk_lowscatter), as the JAX server does; "twotier" takes
    ``ops/bm25.topk_twotier``.
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


def serve_http(
    service: QueryService,
    llm=None,
    host: str = "127.0.0.1",
    port: int = 8080,
    context_policy: str = "concat",
) -> ThreadingHTTPServer:
    """Start the HTTP front end (returns the server; call serve_forever).
    ``llm`` generates the ``/answer`` text; ``context_policy`` is its
    default policy, which a request may override."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args) -> None:  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "documents": len(service.retriever)})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid json"})
                return
            if self.path == "/search":
                queries = payload.get("queries") or [payload.get("query", "")]
                if isinstance(queries, str):  # one query, not its characters
                    queries = [queries]
                k = int(payload.get("k", 10))
                self._send(200, {"results": service.search(list(queries), k)})
            elif self.path == "/ingest":
                rows = payload.get("documents") or []
                try:
                    docs = [Document.from_dict(row) for row in rows]
                except (KeyError, TypeError):
                    self._send(400, {"error": "documents need id and text"})
                    return
                self._send(200, service.ingest(docs))
            elif self.path == "/answer":
                question = payload.get("question", "")
                k = int(payload.get("k", 10))
                policy = payload.get("context_policy", context_policy)
                # Top-1 context by default; context_passages widens it.
                n_ctx = int(payload.get("context_passages", 1))
                hits = service.search([question], k)[0]
                context = " ".join(h["text"] for h in hits[:n_ctx])[:2000]
                if llm is not None and policy == "per_passage":
                    answer, context = generate_answer_per_passage(
                        llm, question, [h["text"][:2000] for h in hits[: max(n_ctx, 3)]])
                elif llm is not None:
                    answer = generate_answer(llm, question, context)
                else:
                    answer = hits[0]["text"] if hits else ""
                confidence = 1.0 - ConformalRAG.estimate_nonconformity(answer, context)
                self._send(200, {"answer": answer, "confidence": confidence, "passages": hits})
            else:
                self._send(404, {"error": "not found"})

    server = ThreadingHTTPServer((host, port), Handler)
    logger.info("Serving on http://%s:%d", host, server.server_address[1])
    return server


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Serve the hybrid index")
    parser.add_argument("--bm25-path", default="./data/bm25_index.json")
    parser.add_argument("--dense-dir", default="./data/dense_index")
    parser.add_argument("--router-checkpoint", default=None,
                        help="trained router (router/train.py checkpoint)")
    parser.add_argument(
        "--encoder-checkpoint", default="models/encoder/encoder.msgpack",
        help="trained TransformerEmbedder for the dense side; pass '' to use "
        "the configured hash embedder")
    parser.add_argument(
        "--lm-checkpoint", default="models/tiny_lm/tiny_lm.msgpack",
        help="trained TinyLM for /answer; pass '' to return the top passage")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--context-policy", default="concat", choices=("concat", "per_passage"),
        help="/answer default context policy (a request may override it)")
    parser.add_argument(
        "--sparse-mode", default="scatter", choices=["scatter", "twotier"],
        help="BM25 pool op: 'scatter' (default) or 'twotier'",
    )
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    service, llm = build_service(args)
    server = serve_http(service, llm=llm, host=args.host, port=args.port,
                        context_policy=args.context_policy)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


def build_service(args: argparse.Namespace):
    """(QueryService, generator or None) from ``main``'s arguments: the
    checkpoints the JAX server loads by default, where their files exist."""
    embedder = None
    if args.encoder_checkpoint and os.path.exists(args.encoder_checkpoint):
        embedder = load_encoder_checkpoint(args.encoder_checkpoint, device=args.device)
        logger.info("Serving with trained encoder %s", args.encoder_checkpoint)
    retriever = HybridRetriever(
        bm25_persist_path=args.bm25_path,
        dense_persist_directory=args.dense_dir,
        embedder=embedder,
        device=args.device,
    )
    llm = None
    if args.lm_checkpoint and os.path.exists(args.lm_checkpoint):
        llm = load_lm_checkpoint(args.lm_checkpoint, device=args.device)
        logger.info("Serving with trained TinyLM %s", args.lm_checkpoint)
    router = None
    if args.router_checkpoint:
        router = RetrievalRouter(device=args.device)
        load_router_checkpoint(router, args.router_checkpoint)
    return QueryService(retriever, router=router, sparse_mode=args.sparse_mode), llm


if __name__ == "__main__":
    main()
