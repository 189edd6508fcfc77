"""Tracing and per-stage timing: the counterpart of ``rag_uq_tpu/utils/profiling.py``.

- ``StageTimer`` fills the per-component latency fields of
  ``EfficiencyMetrics`` (router / retrieval / generation) from host clocks,
  optionally after a device barrier;
- ``trace`` records a ``torch.profiler`` trace of a region (CPU and, on a
  card, CUDA activity) and writes it as a Chrome trace into ``log_dir``;
- ``annotate`` names a sub-region of a trace
  (``torch.profiler.record_function``);
- ``device_sync`` waits for the device work queued before it.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def device_sync(x=None) -> None:
    """Barrier: wait for the device work queued so far. With ``x`` (a
    tensor or a nest of them), on the device of its first tensor; without,
    on the current card when there is one. CPU tensors need no barrier."""
    t = _first_tensor(x)
    if t is not None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates per-stage wall-clock seconds across queries.

    Usage:
        timer = StageTimer()
        with timer.stage("retrieval"):
            ...
        metrics = evaluate_efficiency(timer.totals("total"),
                                      retrieval_times=timer.totals("retrieval"))
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self._stages: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            if self.sync:
                device_sync(result)
            self._stages[name].append(time.time() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._stages[name].append(seconds)

    def totals(self, name: str) -> List[float]:
        return list(self._stages.get(name, []))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._stages.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1000),
                "p95_ms": float(np.percentile(arr, 95) * 1000),
            }
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace around a region and write it to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing). No
    trace without ``log_dir``. CUDA activity is recorded where a card is
    present."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    logger.info("Saved profiler trace to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named sub-region inside a trace."""
    with torch.profiler.record_function(name):
        yield
