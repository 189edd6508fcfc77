"""The expert layers' share of their roofline in the profiled call: their
least time (``_gen_roofline.moe_least_s``) over the device time of the
kernels under the port's ``moe`` ranges (%)."""

from benchmark.metrics._gen_layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "moe")
