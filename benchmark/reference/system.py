"""The plain reference of a deployment: the same answers from the same inputs.

``Reference(cfg, inputs, device)`` rebuilds both towers from what the
harness made (the corpus, the hash table, the router's weights) and ranks
query batches in float64. ``storage`` overrides the stated storage
precision of the dense rows, the query vectors and the impact matrix: the
control's precision. Nothing here imports the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import fusion, text
from benchmark.reference.bm25 import BM25, storage_round

CHUNK = 256


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


class Reference:
    def __init__(self, cfg: Dict, inputs: Dict, device, storage: Optional[str] = None):
        self.cfg, self.device = cfg, device
        self.storage = storage or cfg["dense"]["dtype"]
        b = dict(cfg["bm25"])
        self.max_terms = b["max_query_terms"]
        terms, lengths = inputs["terms"], inputs["lengths"]
        self.vocab = cfg["corpus"]["vocab"]
        self.bm25 = BM25([row[:n] for row, n in zip(terms, lengths)], self.vocab, b,
                         self.device, impact_dtype=storage)
        d = cfg["dense"]
        self.table = inputs["table"].to(self.device).double()
        feats, counts = text.bulk_term_features(terms, lengths, self.vocab, d["buckets"],
                                                d["max_len"])
        self.rows = torch.cat([self._bag(feats[lo : lo + 1024], counts[lo : lo + 1024])
                               for lo in range(0, len(lengths), 1024)])
        r = inputs["router"]
        self.router = fusion.Router(
            hidden=[(w.to(self.device), bias.to(self.device)) for w, bias in r["weights"][:-1]],
            out=tuple(t.to(self.device) for t in r["weights"][-1]), stats=r["stats"],
            feature_set=r["config"]["feature_set"], fuse_norm=r["config"]["fuse_norm"],
            gate_policy=r["config"]["gate_policy"])

    # -- the towers ------------------------------------------------------------------

    def _bag(self, feats: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        ids = torch.as_tensor(feats, device=self.device)
        n = torch.as_tensor(counts, device=self.device)
        mask = (torch.arange(ids.shape[1], device=self.device)[None, :] < n[:, None]).double()
        mean = (self.table[ids] * mask[:, :, None]).sum(1) / n.clamp(min=1)[:, None].double()
        return storage_round(_unit(mean), self.storage)

    def _query_vecs(self, queries: List[str]) -> torch.Tensor:
        d = self.cfg["dense"]
        feats, counts = text.padded([text.ngram_features(q, d["buckets"], d["max_len"])
                                     for q in queries], d["max_len"])
        return self._bag(feats, counts)

    def _query_ids(self, query: str) -> List[int]:
        return [int(t) if t.isdigit() and int(t) < self.vocab else -1
                for t in text.tokenize(query)[: self.max_terms]]

    # -- ranking ---------------------------------------------------------------------

    def _pools(self, queries: List[str]):
        """Both towers' exact scores [Q, N] and pools, and the union's columns."""
        pool = self.cfg["fusion"]["pool"]
        n = self.rows.shape[0]
        cos = self._query_vecs(queries) @ self.rows.T
        d_vals, d_pos = torch.topk(cos, min(pool, n), dim=1)
        bm = self.bm25.scores([self._query_ids(q) for q in queries])
        b_vals, b_pos = torch.topk(bm, min(pool, n), dim=1)
        if n < pool:
            pad = lambda v, p: (torch.nn.functional.pad(v, (0, pool - n)),
                                torch.nn.functional.pad(p, (0, pool - n), value=-1))
            d_vals, d_pos = pad(d_vals, d_pos)
            b_vals, b_pos = pad(b_vals, b_pos)
        cols = fusion.union_pool(d_vals, d_pos, b_vals, b_pos)
        return cos, bm, (d_vals, d_pos, b_vals, b_pos), cols

    def union(self, queries: List[str]):
        """The union pool's columns (positions, BM25, dense) [Q, 2 * pool]."""
        parts = [self._pools(queries[lo : lo + CHUNK])[3] for lo in range(0, len(queries), CHUNK)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def rank(self, queries: List[str], force: Optional[bool] = None) -> fusion.Ranking:
        """The reference's ranking of every union column, for a batch."""
        out = [self._rank(queries[lo : lo + CHUNK], force) for lo in range(0, len(queries), CHUNK)]
        return fusion.concat(out)

    def _rank(self, queries: List[str], force: Optional[bool]) -> fusion.Ranking:
        pool = self.cfg["fusion"]["pool"]
        cos, bm, (d_vals, d_pos, b_vals, b_pos), (pos, bcol, dcol) = self._pools(queries)
        # Documents tied at a pool's cut: within the tolerance of the last
        # place, on either side of it. Which of them a pool takes is either
        # side's choice.
        chk = self.cfg["check"]
        d_tied = b_tied = torch.zeros_like(cos, dtype=torch.bool)
        if cos.shape[1] > pool:
            d_tied = (cos - d_vals[:, pool - 1 : pool]).abs() <= chk["dense_cut_atol"]
            last = b_vals[:, pool - 1 : pool]
            b_tied = ((bm - last).abs() <= chk["bm25_cut_rtol"] * last) & (bm > 0) & (last > 0)
        r = fusion.rank(self.router, pos, bcol, dcol, force)
        r.docs = fusion.documents(pos, bcol, dcol, bm, cos, b_pos, b_vals, d_pos, b_tied, d_tied)
        return r

    def judge(self, queries: List[str], port_pos: np.ndarray, port_val: np.ndarray):
        """(match [Q] bool, score error [Q], foreign documents [Q], ambiguous
        [Q] bool, dense arm [Q] bool, the port's dense arm [Q] bool, margin
        [Q]) of the port's top-k for ``queries``; a query whose binary
        decision lies within the configured margin of 0.5 may take either
        tower. An ambiguous query returns, or the reference ranks in its
        top-k, a document tied at a pool's cut: its order is not judged, its
        scores are. The dense arm and the margin (|mean gate - 0.5|) are the
        reference's; the port's arm is read from its reported scores."""
        parts = [self._judge(queries[lo : lo + CHUNK], port_pos[lo : lo + CHUNK],
                             port_val[lo : lo + CHUNK]) for lo in range(0, len(queries), CHUNK)]
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(7))

    def _judge(self, queries, port_pos, port_val):
        chk = self.cfg["check"]
        k = port_pos.shape[1]
        pp = torch.as_tensor(port_pos, device=self.device).long()
        pv = torch.as_tensor(port_val, device=self.device).double()
        r = self._rank(queries, None)
        match = fusion.judge(r, pp, k, chk["tie_rtol"], chk["tie_atol"])
        err, foreign = fusion.doc_err(r, pp, pv, chk["decision_margin"])
        ambiguous = fusion.touches_cut(r, pp, k)
        close = r.margin < chk["decision_margin"]
        if bool(close.any()):
            idx = torch.nonzero(close)[:, 0].tolist()
            sub = [queries[i] for i in idx]
            for arm in (False, True):
                ra = self._rank(sub, force=arm)
                match[idx] |= fusion.judge(ra, pp[idx], k, chk["tie_rtol"], chk["tie_atol"])
        seen = fusion.port_arm(r, pp, pv)
        return tuple(x.cpu().numpy() for x in (match, err, foreign, ambiguous, r.arm, seen,
                                               r.margin))
