"""The generator's prefill of a call's distinct prompts: CUDA ms of the
port's ``generate.prefill`` spans, mean over the window's calls (ms)."""

from benchmark.metrics._gen_layer import window_cuda_ms


def read(ctx):
    ms = window_cuda_ms(ctx, "generate.prefill")
    return sum(ms) / len(ms) if ms else None
