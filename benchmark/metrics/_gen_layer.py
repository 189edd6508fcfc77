"""What the generator's readers share: the window's spans of one name, and
the share of a profiled call's device time under one of the generator's
ranges that the range's least time (``_gen_roofline``) is."""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark.metrics import _gen_roofline as gr
from benchmark.metrics._common import PEAKS


def window_cuda_ms(ctx: Dict, name: str) -> List[float]:
    """CUDA ms of the port's ``name`` spans that ended inside the window."""
    prog = (ctx or {}).get("program") or {}
    end = (ctx or {}).get("end_ns")
    return [s.cuda_ms for s in (prog.get("window") or {}).get("spans", [])
            if s.name == name and s.cuda_ms is not None and end and s.end_ns <= end]


def roofline_pct(ctx: Dict, name: str) -> Optional[float]:
    p = (ctx or {}).get("profile")
    if not p or not p.get("range_s", {}).get(name):
        return None
    call = p["call"]
    least = {"mla": gr.mla_least_s, "moe": gr.moe_least_s}[name](
        ctx["model"], call["prompt_lens"], call["group"], call["steps"], PEAKS)
    return 100.0 * least / p["range_s"][name]
