"""The ``batch`` mode: back-to-back ``hybrid_search_batch`` calls
(``traffic_modes.Batch``)."""

from benchmark.traffic_modes import Batch as Mode  # noqa: F401
