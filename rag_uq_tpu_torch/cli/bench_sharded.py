"""Tie-aware top-k agreement: the port's copy of
``rag_uq_tpu/cli/bench_sharded.py::tie_aware_agreement``.

The sharded benchmark itself waits for the multi-device slice; this module
holds the comparison that decides whether two top-k results agree under the
tie rule, used to hold the CUDA kernel against its plain twin.
"""

from __future__ import annotations

import numpy as np


def tie_aware_agreement(
    fv: np.ndarray, fp: np.ndarray, uv: np.ndarray, up: np.ndarray,
    rtol: float = 1e-5, atol: float = 1e-6,
) -> dict:
    """Compare top-k results (fv, fp) against a reference (uv, up).

    The contract: scores equal rank by rank within ``atol + rtol * |score|``,
    and every index disagreement confined to a maximal rank class of scores
    equal at that resolution. One addition to the JAX copy: a class that
    reaches rank k may continue past the cut, so its members are checked by
    score alone (either side's choice from a tie at the cut is a valid
    top-k).

    Returns raw positional agreement, rank-wise max |score diff|, tie-aware
    agreement, and per-query diagnostics for every disagreement that is not
    provably a tie.
    """
    n_q, k = fv.shape
    raw = float(np.mean(fp == up)) if fp.size else 1.0
    finite = np.isfinite(uv) & np.isfinite(fv)
    score_diff = float(np.max(np.abs(fv[finite] - uv[finite]))) if finite.any() else 0.0
    tie_ok = 0
    violations = []
    for q in range(n_q):
        if np.array_equal(fp[q], up[q]):
            tie_ok += 1
            continue
        if not np.allclose(fv[q], uv[q], rtol=rtol, atol=atol):
            violations.append({
                "query": int(q),
                "kind": "rankwise_score_mismatch",
                "fused_scores": fv[q].tolist(),
                "unfused_scores": uv[q].tolist(),
                "fused_pos": fp[q].tolist(),
                "unfused_pos": up[q].tolist(),
            })
            continue
        bad = []
        i = 0
        while i < k:
            j = i + 1
            while j < k and abs(uv[q, j] - uv[q, i]) <= (atol + rtol * abs(uv[q, i])):
                j += 1
            if j < k and set(map(int, fp[q, i:j])) != set(map(int, up[q, i:j])):
                bad.append({
                    "rank_class": [int(i), int(j)],
                    "score": float(uv[q, i]),
                    "fused_ids": fp[q, i:j].tolist(),
                    "unfused_ids": up[q, i:j].tolist(),
                })
            i = j
        if bad:
            violations.append({
                "query": int(q),
                "kind": "tie_class_membership_mismatch",
                "classes": bad,
                "fused_scores": fv[q].tolist(),
                "unfused_scores": uv[q].tolist(),
            })
        else:
            tie_ok += 1
    return {
        "raw_idx_agreement": raw,
        "rankwise_max_abs_score_diff": score_diff,
        "tie_aware_agreement": tie_ok / max(n_q, 1),
        "violations": violations,
    }
