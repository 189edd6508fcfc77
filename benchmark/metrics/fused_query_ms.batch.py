"""The fused query (both pools, the union, the router, the top-k), CUDA
events around each call, mean over the window's calls (ms)."""


def read(ctx):
    ms = ctx["rec"].cuda_ms("fused_query") if ctx else []
    return sum(ms) / len(ms) if ms else None
