"""The BM25 pool's least time (its postings, query ids and outputs at the
HBM peak, ``_roofline.bm25_pool_bytes``) over its CUDA-event time, summed
over the window's calls (%)."""

from benchmark.metrics._common import batch_least_s


def read(ctx):
    ms = ctx["rec"].cuda_ms("bm25_pool") if ctx else []
    if not ms or len(ms) != len(ctx["batch_queries"]):
        return None
    return 100.0 * sum(b for b, _, _ in batch_least_s(ctx)) / (sum(ms) * 1e-3)
