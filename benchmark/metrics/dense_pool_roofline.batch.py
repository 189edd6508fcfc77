"""The dense pool's least time (2 B N D operations at the bf16 peak, or its
rows, queries and outputs at the HBM peak, whichever is longer) over its
CUDA-event time, summed over the window's calls (%)."""

from benchmark.metrics._common import batch_least_s


def read(ctx):
    ms = ctx["rec"].cuda_ms("dense_pool") if ctx else []
    if not ms or len(ms) != len(ctx["batch_queries"]):
        return None
    return 100.0 * sum(d for _, d, _ in batch_least_s(ctx)) / (sum(ms) * 1e-3)
