"""Latent attention's share of its roofline in the profiled call: its least
time (``_gen_roofline.mla_least_s``: the prefill and every decode step of
the call, each layer) over the device time of the kernels under the port's
``mla`` ranges (%)."""

from benchmark.metrics._gen_layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "mla")
