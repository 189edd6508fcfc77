"""The whole step's share of the card's peak: the least times of the BM25
pool, the dense pool and the fusion tail, summed over the window's calls,
over the window's wall time (%)."""

from benchmark.metrics._common import batch_least_s


def read(ctx):
    if not ctx or not ctx["batch_queries"]:
        return None
    return 100.0 * sum(sum(t) for t in batch_least_s(ctx)) / ctx["elapsed"]
