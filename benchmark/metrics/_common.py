"""Helpers the per-layer readers share: the peaks table and per-call sums."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

PEAKS: Dict = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def span_sum_s(ctx: Dict, *names: str) -> float:
    rec = ctx["rec"]
    return sum(sum(rec.span_s(n)) for n in names)


def idle_pct(ctx: Dict) -> Optional[float]:
    """The profiled sub-window's share with nothing running on the device;
    only from a trace whose heap-kernel launches match the port's counter."""
    p = ctx.get("profile")
    if not p or not p["ok"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def batch_least_s(ctx: Dict):
    """Per call of the window: (BM25 pool, dense pool, fusion tail) least seconds."""
    from benchmark.metrics import _roofline as rl

    out = []
    for queries in ctx["batch_queries"]:
        ids = [int(t) for q in queries for t in q.split() if t.isdigit()]
        b = len(queries)
        bm = rl.least_s(0.0, rl.bm25_pool_bytes(ctx["df"], ids, len(ids), b, ctx["pool"]), PEAKS)
        dn = rl.least_s(rl.dense_pool_ops(b, ctx["rows"], ctx["dim"]),
                        rl.dense_pool_bytes(b, ctx["rows"], ctx["dim"], ctx["pool"]), PEAKS)
        tl = rl.least_s(rl.tail_ops(b, 2 * ctx["pool"], ctx["router_params"]),
                        rl.tail_bytes(b, ctx["pool"], ctx["k"]), PEAKS)
        out.append((bm, dn, tl))
    return out
