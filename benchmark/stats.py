"""Spreads.

``spread`` is the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median, the
measure the bounds in ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
