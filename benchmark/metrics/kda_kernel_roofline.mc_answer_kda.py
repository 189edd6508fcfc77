"""The KDA decode kernel's share of its roofline in the profiled call: the
least time of the launches the trace holds (``_kda_roofline.kernel_bytes``
at the call's rows, a distinct prompt's slots times the prompts, at the HBM
peak) over those kernels' device time, by the kernel's name (%)."""

from benchmark.metrics import _kda_roofline as kr
from benchmark.metrics._common import PEAKS


def read(ctx):
    p = (ctx or {}).get("profile")
    if not p or not p.get("kda_kernel_s"):
        return None
    call = p["call"]
    least = kr.kernel_least_s(ctx["model"], call["prompts"] * call["group"],
                              p["kda_kernel_launches"], PEAKS)
    return 100.0 * least / p["kda_kernel_s"]
