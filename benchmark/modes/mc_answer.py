"""The ``mc_answer`` mode: MC-confidence answers over retrieved context, a
closed loop of back-to-back calls.

Each call takes the next of ``batches`` seeded batches of ``questions``
questions (spans of source passages, ``generate.span_queries``, as
``fiqa.batch`` draws them), retrieves their top ``top_k`` with
``hybrid_search_batch`` in ``sparse_mode``, joins each question's passages
into one context, and asks ``MCDropoutConfidence.get_confidence_batch`` for
``samples`` samples of at most ``max_tokens`` tokens a question, with
temperatures and top-p drawn from the given ranges: the port's MC path, on
the deployment's generator. ``batch_qps`` counts the questions answered with
all their samples over the whole window, the last call's overrun included.

With ``--trace``, the port's counters are read at the window's end, and the
readers take the window's spans and counters alone. Then, on the card,
``torch.profiler`` records one more call, outside the window: the profiler
slows a call by half and reading its events takes minutes, which the
window's rates must not hold. Of that call the device time of the kernels
launched inside the generator's ``mla`` and ``moe`` ranges is summed, and
its shapes are kept for the rooflines. After that, ``release`` makes one
more call with the generator keeping ``judged_questions`` questions' rows
(one sample each, two of ``judged_doubles`` of them) for the judge.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from benchmark import generate
from benchmark import trace as tr

RANGES = ("mla", "moe")


def range_device_s(events, names=RANGES) -> Dict[str, float]:
    """Seconds of device kernels launched inside each named host range: the
    profiler ties each kernel to the host op that launched it, and a range's
    ``device_time_total`` sums those of every op inside it."""
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    return {name: 1e-6 * sum(e.device_time_total for e in host if e.name == name)
            for name in names}


class Mode:
    def __init__(self, dep, cfg: Dict, traffic: Dict, seed: int, device: str):
        from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence

        self.dep, self.cfg, self.traffic, self.seed, self.device = dep, cfg, traffic, seed, device
        ret = dep.inputs["retrieval_cfg"]
        terms, lengths = dep.inputs["terms"], dep.inputs["lengths"]
        self.texts = generate.passage_texts(terms, lengths)
        self.batches = [generate.span_queries(seed, f"mc_answer{i}", terms, lengths,
                                              traffic["questions"], ret["queries"]["length"])[1]
                        for i in range(traffic["batches"])]
        self.mc = MCDropoutConfidence(
            dep.lm, n_samples=traffic["samples"], max_tokens=traffic["max_tokens"],
            temperature_range=tuple(traffic["temperature_range"]),
            top_p_range=tuple(traffic["top_p_range"]), seed=int(seed) % 2**63, device=device)
        self.profile = None
        self.unanswered = 0
        self.out = None

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def call(self, questions: List[str]) -> int:
        """One call: the questions answered with all their samples."""
        t = self.traffic
        _, pos = self.dep.retriever.hybrid_search_batch(
            questions, top_k=t["top_k"], retrieval_pool_size=self.dep.cfg["fusion"]["pool"],
            router=self.dep.router, sparse_mode=t["sparse_mode"])
        contexts = [" ".join(self.texts[p] for p in row if p >= 0) for row in pos.tolist()]
        results = self.mc.get_confidence_batch(t["instruction"], contexts, questions)
        stats = self.dep.lm.last_stats
        want = len(questions) * t["samples"]
        missing = max(want - stats["rows"], 0) + stats["empty_rows"] \
            + max(len(questions) - len(results), 0)
        self.unanswered += missing
        return len(questions) if missing == 0 else 0

    def instrument(self, rec: tr.Recorder, trace: bool) -> None:
        if trace:
            self.call = rec.timed(self.call, "call", cuda=self.device == "cuda")

    def warm(self) -> None:
        """Every batch once: each brings its own prompt lengths."""
        for qs in self.batches:
            self.call(qs)
        self._sync()

    def _profiled(self, questions: List[str]) -> int:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._sync()
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        t0 = time.perf_counter()
        try:
            answered = self.call(questions)
        finally:
            self._sync()
            t1 = time.perf_counter()
            prof.__exit__(None, None, None)
        events = prof.events()
        names = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
        dev_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
        # Ranges show on the device's timeline too; only kernels, copies and sets count.
        out = tr.reduce_profile(events, t1 - t0, names & dev_names)
        out["range_s"] = range_device_s(events)
        out["call"] = dict(self.dep.lm.last_stats)
        self.profile = out
        return answered

    def window(self, seconds: float, rec: tr.Recorder, trace: bool) -> Dict:
        from rag_uq_tpu_torch.utils import profiling

        answered, calls, asked, call_s = 0, 0, 0, []
        t0 = time.perf_counter()
        while True:
            qs = self.batches[calls % len(self.batches)]
            t_call = time.perf_counter()
            answered += self.call(qs)
            call_s.append(time.perf_counter() - t_call)
            calls += 1
            asked += len(qs)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.out = {"calls": calls, "elapsed": elapsed, "end_ns": time.perf_counter_ns(),
                    "counters": profiling.counters()}
        extra = {"calls": calls, "call_s_median": statistics.median(call_s)}
        if trace and self.device == "cuda":
            self._profiled(self.batches[calls % len(self.batches)])
            extra["profiled_call_s"] = self.profile["window_s"]
        extra["unanswered"] = self.unanswered
        return {"e2e": {"batch_qps": answered / elapsed}, "attempted": asked,
                "failed": asked - answered, "extra": extra}

    def layer_context(self, rec: tr.Recorder, window: Dict) -> Dict:
        if not rec.spans:
            return {}
        return {"rec": rec, "profile": self.profile, "model": self.cfg, **self.out}

    def release(self) -> Dict:
        """The judged sample: one more call with the generator keeping the
        rows of ``judged_questions`` questions drawn from the seed."""
        from rag_uq_tpu_torch.llm.deepseek_v2 import Capture

        t = self.traffic
        r = generate.rng(self.seed, "judge")
        qs = self.batches[int(r.integers(len(self.batches)))]
        picked = r.choice(len(qs), size=t["judged_questions"], replace=False)
        rows = []
        for j, q in enumerate(sorted(picked.tolist())):
            n = 2 if j < t["judged_doubles"] else 1
            rows += [q * t["samples"] + int(s) for s in r.choice(t["samples"], n, replace=False)]
        lm = self.dep.lm
        lm.capture = Capture(rows)
        try:
            self.call(qs)
        finally:
            cap, lm.capture = lm.capture, None
        self.mc = None
        self.dep = None
        return {"rows": cap.out["rows"], "unanswered": self.unanswered}
