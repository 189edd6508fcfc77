"""The traffic of the ``synthetic_hybrid`` kind's mixes. A mix names its
mode in ``mode``, and ``benchmark/modes/<mode>.py`` binds the class here:

- ``batch`` (``Batch``): ``HybridRetriever.hybrid_search_batch`` on
  ``batches`` distinct batches of ``batch`` queries, in turn, back to back,
  until the window's seconds have passed. The rate counts every query of
  every call over the whole time, the last call's overrun included.

Queries come from the configuration's ``queries`` section: spans of source
passages (``passage_span``). A mode warms the shapes its traffic uses and
no others, runs the window, gives the per-layer readers their context, and
hands the sampled answers to the judge once the program's state is
released.
"""

from __future__ import annotations

import resource
import time
from contextlib import ExitStack
from typing import Dict, List

import numpy as np
import torch

from benchmark import generate
from benchmark import trace as tr


def _queries(dep, cfg: Dict, seed: int, stream: str, n: int) -> List[str]:
    q = cfg["queries"]
    if q["kind"] != "passage_span":
        raise ValueError(f"unknown query kind {q['kind']!r}")
    return generate.span_queries(seed, stream, dep.inputs["terms"], dep.inputs["lengths"],
                                 n, q["length"])[1]


def _df(dep) -> Dict[int, int]:
    """Documents holding each term id, from the harness's corpus."""
    terms, lengths = dep.inputs["terms"], dep.inputs["lengths"]
    mask = np.arange(terms.shape[1])[None, :] < lengths[:, None]
    pairs = np.unique(np.stack([np.nonzero(mask)[0], terms[mask]]), axis=1)
    ids, counts = np.unique(pairs[1], return_counts=True)
    return dict(zip(ids.tolist(), counts.tolist()))


def process_cpu_s() -> float:
    """CPU seconds this process has spent, all its threads together."""
    return sum(resource.getrusage(resource.RUSAGE_SELF)[:2])


def run_batch(search, batches, seconds: float, during=lambda i: None) -> Dict:
    """``search`` on ``batches`` in turn until ``seconds`` have passed."""
    results, ends, t0 = [], [], time.perf_counter()
    i = 0
    while True:
        during(i)
        vals, pos = search(batches[i % len(batches)])
        results.append((i % len(batches), vals, pos))
        ends.append(time.perf_counter() - t0)
        i += 1
        if ends[-1] >= seconds:
            break
    queries = sum(len(batches[b]) for b, _, _ in results)
    return {"results": results, "elapsed": ends[-1], "queries": queries, "calls": i,
            "ends": ends}


class Batch:
    # Every range the harness records, and so labels idle gaps with.
    _span_names = ("host_encode.embed", "host_encode.terms", "fused_query", "bm25_pool",
                   "dense_pool", "fusion_tail", "make_fused", "call")

    def __init__(self, dep, cfg: Dict, traffic: Dict, seed: int, device: str):
        self.dep, self.cfg, self.traffic, self.seed, self.device = dep, cfg, traffic, seed, device
        self.k = cfg["fusion"]["k"]
        self.pool = cfg["fusion"]["pool"]
        self.profile = None
        self.batches = [_queries(dep, cfg, seed, f"batch{i}", traffic["batch"])
                        for i in range(traffic["batches"])]
        self.search = lambda qs: dep.retriever.hybrid_search_batch(
            qs, top_k=self.k, retrieval_pool_size=self.pool, router=dep.router,
            sparse_mode=cfg["fusion"]["sparse_mode"])

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _launches(self) -> int:
        from rag_uq_tpu_torch.ops.cosine_topk import cuda_cosine_topk

        return cuda_cosine_topk.launches

    def instrument(self, rec: tr.Recorder, trace: bool) -> None:
        if not trace:
            return
        from rag_uq_tpu_torch.ops import bm25 as bm25_ops
        from rag_uq_tpu_torch.retrieval import fused as fused_mod
        from rag_uq_tpu_torch.retrieval import hybrid as hybrid_mod

        sync = self.device == "cuda"
        rec.wrap(self.dep.retriever.dense_index, "embed_queries", "host_encode.embed", sync=sync)
        rec.wrap(hybrid_mod, "encode_for_fused", "host_encode.terms")
        make = hybrid_mod.make_fused_hybrid_query
        rec.wrap(hybrid_mod, "make_fused_hybrid_query", "make_fused")
        hybrid_mod.make_fused_hybrid_query = lambda *a, **kw: rec.timed(
            make(*a, **kw), "fused_query", cuda=True)
        rec.wrap(bm25_ops, "topk_lowscatter", "bm25_pool", cuda=True)
        rec.wrap(fused_mod, "dense_pool", "dense_pool", cuda=True)
        rec.wrap(fused_mod, "fuse_pools_select", "fusion_tail", cuda=True)
        self.search = rec.timed(self.search, "call")

    def warm(self) -> None:
        for qs in (self.batches[0], self.batches[1 % len(self.batches)], self.batches[0]):
            self.search(qs)
        self._sync()

    def _close_profile(self, out: Dict) -> None:
        self.profile = out
        self.profile["ok"] = out["heap_kernels"] == out["launches"]

    def window(self, seconds: float, rec: tr.Recorder, trace: bool) -> Dict:
        """The window; with ``trace``, ``torch.profiler`` over
        ``profile_calls`` calls from 30% of it."""
        stack, n_prof = ExitStack(), self.traffic.get("profile_calls", 3)
        state = {"start": None}
        t0 = time.perf_counter()

        def during(i: int) -> None:
            if not trace or self.device != "cuda":
                return
            if state["start"] is None and time.perf_counter() - t0 >= seconds * 0.3:
                state["start"] = i
                state["out"] = stack.enter_context(tr.profile_window(
                    self._launches, prefer=set(rec.spans) | set(self._span_names)))
            elif state["start"] is not None and i == state["start"] + n_prof:
                stack.close()
                self._close_profile(state["out"])

        cpu0 = process_cpu_s()
        out = run_batch(self.search, self.batches, seconds, during)
        stack.close()
        if self.profile is None and "out" in state:
            self._close_profile(state["out"])
        self.out = out
        # Beside the rate: the first and second halves' rates, and the cores
        # this process kept busy.
        ends = np.asarray(out["ends"])
        half = int(np.searchsorted(ends, ends[-1] / 2))
        size = self.traffic["batch"]
        halves = [size * (half + 1) / ends[half],
                  size * (len(ends) - half - 1) / max(ends[-1] - ends[half], 1e-9)]
        return {"e2e": {"batch_qps": out["queries"] / out["elapsed"]},
                "attempted": out["queries"], "failed": 0,
                "extra": {"halves_qps": [round(float(h), 1) for h in halves],
                          "process_cores": round((process_cpu_s() - cpu0) / out["elapsed"], 3)}}

    def layer_context(self, rec: tr.Recorder, window: Dict) -> Dict:
        if not rec.spans:
            return {}
        d = self.dep.retriever.dense_index
        return {"rec": rec, "profile": self.profile, "df": _df(self.dep),
                "batch_queries": [self.batches[b] for b, _, _ in self.out["results"]],
                "calls": self.out["calls"], "elapsed": self.out["elapsed"],
                "rows": len(d), "dim": d.config.embedding_dim, "pool": self.pool,
                "k": self.k, "router_params": self.dep.router.num_params()}

    def release(self) -> Dict:
        """The judged sample: ``compare_calls`` of the window's calls drawn
        from the seed, their queries and the port's answers."""
        results = self.out["results"]
        pick = generate.rng(self.seed, "judge").choice(
            len(results), size=min(self.traffic["compare_calls"], len(results)), replace=False)
        queries, pos, vals = [], [], []
        for i in sorted(pick.tolist()):
            b, v, p = results[i]
            queries += self.batches[b]
            pos.append(p)
            vals.append(v)
        self.out = None
        return {"queries": queries, "pos": np.concatenate(pos), "vals": np.concatenate(vals),
                "unanswered": 0}
