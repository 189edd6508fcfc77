"""Host encoding a call: the dense query embedding (synchronized) and the
BM25 term encoding, host clock, mean over the window's calls (ms)."""

from benchmark.metrics._common import span_sum_s


def read(ctx):
    calls = len(ctx["rec"].span_s("host_encode.embed")) if ctx else 0
    if not calls:
        return None
    return 1e3 * span_sum_s(ctx, "host_encode.embed", "host_encode.terms") / calls
