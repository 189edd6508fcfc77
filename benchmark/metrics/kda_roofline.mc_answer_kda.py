"""The KDA layers' share of their roofline in the profiled call: their least
time (``_kda_roofline.kda_least_s``: the chunked prefill and every decode
step of the call, each KDA layer) over the device time of the kernels
under the port's ``kda`` ranges (%)."""

from benchmark.metrics import _kda_roofline as kr
from benchmark.metrics._common import PEAKS


def read(ctx):
    p = (ctx or {}).get("profile")
    if not p or not p.get("range_s", {}).get("kda"):
        return None
    call = p["call"]
    least = kr.kda_least_s(ctx["model"], call["prompt_lens"], call["group"], call["steps"],
                           PEAKS)
    return 100.0 * least / p["range_s"]["kda"]
