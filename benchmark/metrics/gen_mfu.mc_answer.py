"""The generator's share of the card's bf16 peak: the model's operations for
the window's prefill and decode tokens (``_gen_roofline.model_ops`` over the
port's ``gen.*`` counters, read at the window's end) over the window's wall
time (%)."""

from benchmark.metrics import _gen_roofline as gr
from benchmark.metrics._common import PEAKS


def read(ctx):
    counters = (ctx or {}).get("counters") or {}
    if not counters.get("gen.decode_positions") or not ctx.get("elapsed"):
        return None
    return 100.0 * gr.model_ops(ctx["model"], counters) / (ctx["elapsed"] * PEAKS["bf16_flops"])
