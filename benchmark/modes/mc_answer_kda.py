"""The ``mc_answer_kda`` mode: ``mc_answer``'s closed loop of MC-confidence
calls (``modes/mc_answer.py``, whose ``Mode`` this one is), for a generator
with KDA layers.

The profiled call after the window also sums the device time of the
kernels launched inside the generator's ``kda`` ranges (beside ``mla`` and
``moe``), and the device time and launches of the KDA decode kernel
(``KDA_KERNEL``, by name), for the rooflines.
"""

from __future__ import annotations

import time
from typing import List

import torch

from benchmark import trace as tr
from benchmark.modes import mc_answer

RANGES = mc_answer.RANGES + ("kda",)
KDA_KERNEL = "kda_decode_kernel"


class Mode(mc_answer.Mode):
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
        cuda = torch.autograd.DeviceType.CUDA
        names = {e.name for e in events if e.device_type != cuda}
        dev_names = {e.name for e in events if e.device_type == cuda}
        # Ranges show on the device's timeline too; only kernels, copies and sets count.
        out = tr.reduce_profile(events, t1 - t0, names & dev_names)
        out["range_s"] = mc_answer.range_device_s(events, RANGES)
        kernels = [e for e in events if e.device_type == cuda and KDA_KERNEL in e.name]
        out["kda_kernel_s"] = 1e-6 * sum(e.time_range.elapsed_us() for e in kernels)
        out["kda_kernel_launches"] = len(kernels)
        out["call"] = dict(self.dep.lm.last_stats)
        self.profile = out
        return answered
