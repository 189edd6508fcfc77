"""The comparison that decides ``correct``: the port's sampled answers against the reference.

Each sampled query's top-k against the reference's under the tie rule of
``reference/fusion.py::judge``:

- ``mismatch_share``: the share of sampled queries whose top-k is not the
  reference's;
- ``score_err``: the widest gap between a returned document's reported
  score and the reference's score of it;
- ``foreign_docs``: returned documents that no pool of the reference holds
  or may hold;
- ``unanswered``: requests due in the window that never answered;
- ``one_arm_share``: the larger share of the sampled queries that the
  reference's router sends to one tower. It holds the sample to both
  towers, so that a fault in either pool shows; its limit is the
  configuration's.

With ``control``, the reference in the control's precision (float8 e4m3
for the configuration's bfloat16 storage) is put in the port's place on
the same queries, and its numbers are returned beside, as
``control.<name>``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.system import Reference

CONTROL_DTYPE = "float8_e4m3fn"


def run(cfg: Dict, inputs: Dict, judged: Dict, device: str,
        control: bool) -> Tuple[Dict, Dict]:
    """(the compared numbers, each with its limit; the other numbers, the
    control's with ``control``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = cfg["check"]["limits"]
    ref = Reference(cfg, inputs, device)
    numbers = retrieval_numbers(ref, judged["queries"], judged["pos"], judged["vals"])
    numbers["unanswered"] = float(judged["unanswered"])
    extra = {"judged_queries": len(judged["queries"]),
             "ambiguous_share": numbers.pop("ambiguous_share"),
             **{k: numbers.pop(k) for k in ("dense_share", "arm_flips", "arm_flip_margin")}}
    if control:
        low = Reference(cfg, inputs, device, storage=CONTROL_DTYPE)
        pos, vals = control_topk(low, judged["queries"], judged["pos"].shape[1])
        for name, value in retrieval_numbers(ref, judged["queries"], pos, vals).items():
            extra[f"control.{name}"] = value
    # A number the configuration sets no limit for is reported, not judged.
    checks = {name: {"value": float(v), "limit": float(limits[name])}
              for name, v in numbers.items() if name in limits}
    extra.update({name: v for name, v in numbers.items() if name not in limits})
    return checks, extra


def retrieval_numbers(ref: Reference, queries: List[str], pos, vals) -> Dict[str, float]:
    if not len(queries):
        return {"mismatch_share": 1.0, "score_err": 0.0, "foreign_docs": 0.0,
                "one_arm_share": 1.0, "ambiguous_share": 0.0, "dense_share": 0.0,
                "arm_flips": 0.0, "arm_flip_margin": 0.0}
    match, err, foreign, ambiguous, dense, seen, margin = ref.judge(
        queries, np.asarray(pos), np.asarray(vals))
    clear = ~ambiguous
    # Queries whose answers show the other tower than the reference's
    # decision, and the widest decision margin among them: reported beside
    # the checks, for the configuration's ``decision_margin``.
    flips = seen != dense
    return {"mismatch_share": float(1.0 - match[clear].mean()) if clear.any() else 0.0,
            "score_err": float(err.max()), "foreign_docs": float(foreign.sum()),
            "one_arm_share": float(max(dense.mean(), 1.0 - dense.mean())),
            "ambiguous_share": float(ambiguous.mean()), "dense_share": float(dense.mean()),
            "arm_flips": float(flips.sum()),
            "arm_flip_margin": float(margin[flips].max()) if flips.any() else 0.0}


def control_topk(low: Reference, queries: List[str], k: int):
    from benchmark.reference import fusion

    r = low.rank(queries)
    _, _, report, pos = fusion.top(r, k)
    dead = pos < 0
    return pos.cpu().numpy(), torch.where(dead, 0.0, report).cpu().numpy()
