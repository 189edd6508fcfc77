"""A decode step of the generator: CUDA ms of the port's ``generate.decode``
spans over its ``gen.decode_steps`` counter, both summed over the window's
calls (ms)."""

from benchmark.metrics._gen_layer import window_cuda_ms


def read(ctx):
    ms = window_cuda_ms(ctx, "generate.decode")
    steps = ((ctx or {}).get("counters") or {}).get("gen.decode_steps", 0)
    return sum(ms) / steps if ms and steps else None
