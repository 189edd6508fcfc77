"""The union pool, the router's gate, the fusion and the final top-k, in float64.

A query's pool is the union of its dense top-``pool`` and its BM25
top-``pool`` of positive scores, laid out in 2 * ``pool`` columns; a column
carries a tower's score only where the document is in that tower's pool,
else 0, and unfilled columns are dead (score 0). The router (a per-column
MLP over EMA-normalized tower scores, ``pool7`` adding each tower's
within-pool z-score and top-1 minus top-2 gap) gates every column, and
its ``binary`` policy serves, for each query, the tower that the mean gate
over all columns picks (dense above 0.5), max-normalized. The served value
is also the reported score.

``Ranking`` keeps, per query, every column's position, tier (0 live, 2
dead), ranking value and reported score.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

EPS = 1e-6
NEG = float("-inf")


@dataclass
class Router:
    hidden: list  # [(W [in, out], b [out])] float64
    out: tuple  # (W [h, 1], b [1])
    stats: Dict[str, float]  # bm25_mean, bm25_std, dense_mean, dense_std
    feature_set: str
    fuse_norm: str
    gate_policy: str


def union_pool(d_vals, d_pos, b_vals, b_pos):
    """Columns [Q, 2P]: (positions, bm25 column, dense column), -1 dead."""
    d_live = d_pos >= 0
    b_live = (b_pos >= 0) & (b_vals > 0)
    eq = (d_pos[:, :, None] == b_pos[:, None, :]) & d_live[:, :, None] & b_live[:, None, :]
    b_for_d = (eq.double() * b_vals[:, None, :]).sum(-1)
    b_dup = eq.any(1)
    pos = torch.cat([torch.where(d_live, d_pos, -1), torch.where(b_dup | ~b_live, -1, b_pos)], -1)
    bcol = torch.cat([b_for_d, torch.where(b_dup | ~b_live, 0.0, b_vals)], -1)
    dcol = torch.cat([torch.where(d_live, d_vals, 0.0), torch.zeros_like(b_vals)], -1)
    return pos, bcol, dcol


def _normalize(r: Router, b, d):
    if r.fuse_norm == "none":
        return b, d
    return (b / b.amax(-1, keepdim=True).clamp(min=1e-12),
            d / d.amax(-1, keepdim=True).clamp(min=1e-12))


def hidden(r: Router, b, d):
    """The router's last hidden layer [Q, M, H] for every column."""
    b, d = _normalize(r, b, d)
    s = r.stats
    bn = (b - s["bm25_mean"]) / (s["bm25_std"] + EPS)
    dn = (d - s["dense_mean"]) / (s["dense_std"] + EPS)
    cols = [bn, dn, dn - bn]
    if r.feature_set == "pool7":
        m = b.shape[1]

        def zs(x):
            mean = x.mean(1, keepdim=True)
            std = (((x - mean) ** 2).sum(1, keepdim=True) / max(m - 1, 1)).sqrt() + EPS
            top = torch.topk(x, 2, dim=1).values
            return (x - mean) / std, ((top[:, :1] - top[:, 1:2]) / std).expand_as(x)

        bz, bgap = zs(b)
        dz, dgap = zs(d)
        cols += [bz, dz, bgap, dgap]
    x = torch.stack(cols, -1)
    for w, bias in r.hidden:
        x = torch.relu(x @ w + bias)
    return x


def gate(r: Router, b, d):
    """Per-column gate weights [Q, M] in [0, 1]; 1 favours dense."""
    return torch.sigmoid(hidden(r, b, d) @ r.out[0] + r.out[1])[..., 0]


def _fuse(r: Router, weights, b, d, force: Optional[bool] = None):
    bn, dn = _normalize(r, b, d)
    pick = weights.mean(-1, keepdim=True) > 0.5 if force is None else torch.full_like(
        weights[:, :1], force, dtype=torch.bool)
    return torch.where(pick, dn, bn)


@dataclass
class Ranking:
    pos: torch.Tensor  # [Q, M]
    tier: torch.Tensor  # [Q, M] 0 live, 2 dead
    value: torch.Tensor  # [Q, M] ranking value
    report: torch.Tensor  # [Q, M] the reported score
    margin: torch.Tensor  # [Q] |mean gate - 0.5| under binary, else inf
    docs: Optional[Dict[str, torch.Tensor]] = None  # see ``documents``
    kind: str = "fused"  # what the reported score is: "fused" or "binary"
    arm: Optional[torch.Tensor] = None  # [Q] binary: the dense tower was picked


def rank(router: Optional[Router], pos, bcol, dcol, force: Optional[bool] = None) -> Ranking:
    """Every union column ranked; without a router by the mean of the
    towers' max-normalized scores, else by the router's fusion."""
    live = pos >= 0
    q = pos.shape[0]
    inf = torch.full((q,), float("inf"), dtype=torch.float64, device=pos.device)
    if router is None:
        maxn = lambda x: x / torch.where(live, x, NEG).amax(-1, keepdim=True).clamp(min=1e-12)
        fused = torch.where(live, (maxn(bcol) + maxn(dcol)) / 2.0, NEG)
        return Ranking(pos, torch.where(live, 0, 2), fused, fused, inf)
    if router.gate_policy != "binary":
        raise ValueError(f"gate policy {router.gate_policy!r}: the reference serves binary")
    weights = gate(router, bcol, dcol)
    hybrid = torch.where(live, _fuse(router, weights, bcol, dcol, force), NEG)
    margin = (weights.mean(-1) - 0.5).abs()
    out = Ranking(pos, torch.where(live, 0, 2), hybrid, hybrid, margin)
    out.kind = "binary"
    out.arm = weights.mean(-1) > 0.5 if force is None else torch.full_like(margin, force,
                                                                           dtype=torch.bool)
    return out


def top(r: Ranking, k: int):
    """The reference's top-k: (tiers, values, reported) [Q, k] in rank order."""
    key_tier = r.tier.double()
    order = torch.argsort(-torch.where(r.tier < 2, r.value, NEG), dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(torch.gather(key_tier, 1, order), dim=1,
                                                 stable=True))[:, :k]
    return (torch.gather(r.tier, 1, order), torch.gather(r.value, 1, order),
            torch.gather(r.report, 1, order), torch.gather(r.pos, 1, order))


def judge(r: Ranking, port_pos, k: int, rtol: float, atol: float):
    """[Q] bool: the port's top-k is the reference's under the tie rule: at
    each rank a distinct document of the same tier whose ranking value is
    within ``atol + rtol * |value|`` of the reference's at that rank, and a
    dead slot where the reference has fewer than k."""
    t_tier, t_val, _, _ = top(r, k)
    eq = (port_pos[:, :, None] == r.pos[:, None, :]) & (port_pos[:, :, None] >= 0)
    found = eq.any(-1)
    col = eq.double().argmax(-1)
    p_tier = torch.where(found, torch.gather(r.tier, 1, col), 3)
    p_val = torch.gather(r.value, 1, col)
    port_dead = port_pos < 0
    close = (p_val - t_val).abs() <= atol + rtol * t_val.abs()
    same = found & (p_tier == t_tier) & (close | (p_val == t_val))
    ok = torch.where(t_tier == 2, port_dead, same)
    srt = torch.sort(torch.where(port_dead, -1 - torch.arange(k, device=port_pos.device),
                                 port_pos), 1).values
    return ok.all(1) & (srt[:, 1:] != srt[:, :-1]).all(1)


def touches_cut(r: Ranking, port_pos, k: int):
    """[Q] bool: the port's top-k or the reference's holds a document tied at
    a pool's cut."""
    _, _, _, ref_pos = top(r, k)
    seen = torch.cat([port_pos, ref_pos], 1)
    hit = torch.gather(r.docs["tied"], 1, seen.clamp(min=0)) & (seen >= 0)
    return hit.any(1)


def documents(pos, bcol, dcol, bm, cos, b_pos, b_vals, d_pos, b_tied, d_tied) -> Dict:
    """Per query and document [Q, N]: the exact tower scores, whether the
    reference's pools hold the document, whether it is tied at a cut, and
    the union's maxima [Q, 1]."""
    live = pos >= 0
    in_b = torch.zeros_like(bm, dtype=torch.bool).scatter_(1, b_pos.clamp(min=0),
                                                            (b_pos >= 0) & (b_vals > 0))
    in_d = torch.zeros_like(bm, dtype=torch.bool).scatter_(1, d_pos.clamp(min=0), d_pos >= 0)
    mx = lambda col: torch.where(live, col, NEG).amax(-1, keepdim=True).clamp(min=1e-12)
    return {"b": bm, "d": cos, "in_b": in_b, "in_d": in_d, "b_tied": b_tied, "d_tied": d_tied,
            "tied": b_tied | d_tied, "max_b": mx(bcol), "max_d": mx(dcol)}


def concat(parts) -> Ranking:
    """One Ranking of the chunks' rows (without their per-document tables)."""
    out = Ranking(*(torch.cat([getattr(r, f) for r in parts]) for f in
                    ("pos", "tier", "value", "report", "margin")))
    out.kind = parts[0].kind
    if parts[0].arm is not None:
        out.arm = torch.cat([r.arm for r in parts])
    return out


def doc_err(r: Ranking, port_pos, port_val, margin: float):
    """([Q] the widest gap between a returned document's reported score and
    the reference's score of it, [Q] returned documents that no pool of the
    reference holds or may hold). A document tied at a cut is scored with
    that tower counted or not, whichever is closer; a binary decision within
    ``margin`` of 0.5 allows either tower."""
    c = r.docs
    live = port_pos >= 0
    safe = port_pos.clamp(min=0)
    g = {k: torch.gather(c[k], 1, safe) for k in ("b", "d", "in_b", "in_d", "b_tied", "d_tied")}
    found = live & (g["in_b"] | g["in_d"] | g["b_tied"] | g["d_tied"])
    best = torch.full(port_val.shape, float("inf"), dtype=torch.float64, device=port_val.device)
    for flip_b in (False, True):
        for flip_d in (False, True):
            bn = torch.where(g["in_b"] ^ (flip_b & g["b_tied"]), g["b"], 0.0) / c["max_b"]
            dn = torch.where(g["in_d"] ^ (flip_d & g["d_tied"]), g["d"], 0.0) / c["max_d"]
            if r.kind == "binary":
                either = (r.margin < margin)[:, None]
                arm = r.arm[:, None]
                vals = [torch.where(arm, dn, bn), torch.where(either, torch.where(arm, bn, dn),
                                                              torch.where(arm, dn, bn))]
            else:
                vals = [(bn + dn) / 2.0]
            for v in vals:
                best = torch.minimum(best, (port_val - v).abs())
    err = torch.where(found, best, 0.0).amax(1)
    return err, (live & ~found).sum(1)


def port_arm(r: Ranking, port_pos, port_val):
    """[Q] bool: the tower whose max-normalized scores lie closer to the
    port's reported ones (True: dense), the port's binary decision as its
    answers show it."""
    c = r.docs
    live = port_pos >= 0
    safe = port_pos.clamp(min=0)
    g = {k: torch.gather(c[k], 1, safe) for k in ("b", "d", "in_b", "in_d")}
    bn = torch.where(g["in_b"], g["b"], 0.0) / c["max_b"]
    dn = torch.where(g["in_d"], g["d"], 0.0) / c["max_d"]
    gap = lambda v: torch.where(live, (port_val - v).abs(), 0.0).amax(1)
    return gap(dn) < gap(bn)
