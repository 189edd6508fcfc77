"""The Kimi Linear generator's share of the card's bf16 peak: the model's
operations for the window's prefill and decode tokens
(``_kda_roofline.model_ops`` over the port's ``gen.*``, ``kda.*`` and
``moe.local_pairs`` counters, read at the window's end) over the window's
wall time (%)."""

from benchmark.metrics import _kda_roofline as kr
from benchmark.metrics._common import PEAKS


def read(ctx):
    counters = (ctx or {}).get("counters") or {}
    if not counters.get("gen.decode_positions") or not counters.get("kda.prefill_tokens") \
            or not ctx.get("elapsed"):
        return None
    return 100.0 * kr.model_ops(ctx["model"], counters) / (ctx["elapsed"] * PEAKS["bf16_flops"])
