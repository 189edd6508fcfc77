"""The share of the profiled sub-window in which no kernel, copy or set ran
on the card (torch.profiler), where the trace kept every heap-kernel
launch the port counted (%)."""

from benchmark.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx else None
