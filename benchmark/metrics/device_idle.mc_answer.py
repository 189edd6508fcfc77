"""The share of the profiled call in which no kernel, copy or set ran on the
card (torch.profiler) (%)."""


def read(ctx):
    p = (ctx or {}).get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
