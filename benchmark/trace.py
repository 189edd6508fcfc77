"""Spans and the device trace of a traced run, taken from outside the port.

``Recorder.wrap`` replaces an attribute (a module function or a method of
one object) with a wrapper that records a host-clock span, and with
``cuda=True`` a pair of CUDA events, around every call made while the
recorder is on. Spans are kept in memory and read after the window.

``profile_window`` runs ``torch.profiler`` over a sub-window and reduces
it to the device's busy seconds (the union of its kernels', copies' and
sets' intervals), the count of heap-kernel launches it saw, the device
operations by total time and the idle gaps by what the host was running.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List

import torch

HEAP_KERNEL = "chunk_topk_kernel"


class Recorder:
    def __init__(self):
        self.on = False
        self.spans: Dict[str, List[tuple]] = defaultdict(list)
        self.events: Dict[str, List[tuple]] = defaultdict(list)
        self._lock = threading.Lock()
        self._undo: List[Callable] = []

    def wrap(self, owner, attr: str, name: str, cuda: bool = False, sync: bool = False):
        """Record ``name`` around ``owner.attr`` (see ``timed``) until ``restore``."""
        inner = getattr(owner, attr)
        setattr(owner, attr, self.timed(inner, name, cuda, sync))
        self._undo.append(lambda: setattr(owner, attr, inner))

    def timed(self, inner: Callable, name: str, cuda: bool = False,
              sync: bool = False) -> Callable:
        """``inner`` recording ``name`` while the recorder is on; ``sync``
        synchronizes the device before the span ends. Without a card there
        are no events: the readers of device times find nothing."""
        rec = self
        cuda = cuda and torch.cuda.is_available()

        def wrapped(*args, **kwargs):
            if not rec.on:
                return inner(*args, **kwargs)
            label = torch.autograd.profiler.record_function(name)
            label.__enter__()
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            try:
                out = inner(*args, **kwargs)
            finally:
                label.__exit__(None, None, None)
            if cuda:
                end.record()
            if sync:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            with rec._lock:
                rec.spans[name].append((t0, t1))
                if cuda:
                    rec.events[name].append((start, end))
            return out

        return wrapped

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    def cuda_ms(self, name: str) -> List[float]:
        if not self.events.get(name):
            return []
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events.get(name, [])]

    def span_s(self, name: str) -> List[float]:
        return [t1 - t0 for t0, t1 in self.spans.get(name, [])]


def kernel_name(name: str) -> str:
    """A device kernel's name cut to its function and innermost functor."""
    head = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", "")).split("(")[0]
    base = head.split("<")[0].split("::")[-1][:80]
    inner = re.findall(r"(\w+(?:Functor|Op|_functor|Epilogue|_cuda))\b", head)
    return f"{base}/{inner[-1]}" if inner else base


@contextmanager
def profile_window(launches: Callable[[], int], prefer=()):
    """Yields a dict that holds, once the block has run: window_s, busy_s,
    heap_kernels (in the trace), launches (by the port's counter),
    device_ops and idle_gaps (top ten each, seconds)."""
    out: Dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    n0, t0 = launches(), time.perf_counter()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        t1, n1 = time.perf_counter(), launches()
        prof.__exit__(None, None, None)
    out.update(reduce_profile(prof.events(), t1 - t0, set(prefer)))
    out["launches"] = n1 - n0


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start takes seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def reduce_profile(events, window_s: float, prefer=frozenset()) -> Dict:
    # The harness's own ranges show on the device's timeline too; only the
    # device's kernels, copies and sets count.
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in prefer and not e.name.startswith("ProfilerStep")]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged: List[list] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[kernel_name(e.name)] += e.time_range.elapsed_us() * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    host_sorted = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_sorted]
    spans_of = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                       if e.name in prefer))
    span_starts = [s0 for s0, _, _ in spans_of]
    for (_, a), (b, _) in zip(merged, merged[1:]):
        # A gap is labelled by the harness's span open at its midpoint, else
        # by the innermost host range open there.
        mid = (a + b) / 2
        j = bisect.bisect_right(span_starts, mid)
        label = next((n for s0, s1, n in reversed(spans_of[max(0, j - 50) : j]) if s1 >= mid),
                     None)
        if label is None:
            label, best = "host", None
            i = bisect.bisect_right(starts, mid)
            for e in host_sorted[max(0, i - 400) : i]:
                if e.time_range.end >= mid and (best is None or e.time_range.start >= best):
                    label, best = e.name, e.time_range.start
        gaps[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": window_s, "busy_s": busy_us * 1e-6,
            "heap_kernels": sum(1 for e in dev if HEAP_KERNEL in e.name),
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
