"""The deployment: the port's system under test, and the inputs both sides share.

A configuration of ``kind`` ``synthetic_hybrid`` is a corpus of Zipf term
ids made from the seed, the port's ``NgramHashEmbedder`` over a table
drawn on the card from the seed, its BM25 index, and a router of the
configured recipe whose weights are drawn from the seed and whose score
statistics the configuration states.

The router's output bias is then set from a warm batch of queries drawn
from the seed (``calibrate_router``), with the harness's own reference, so
that the router sends about half of the queries to each tower on every
seed. Weights drawn at random send most or all queries of a seed to one
tower, and a sample that only one tower serves cannot show a fault in the
other.

``inputs`` holds what the reference is handed: the corpus, the hash table
and the router's weights as the harness made them. The reference works
everything else out again.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import text as ref_text


@dataclass
class Deployment:
    cfg: Dict
    retriever: Any
    router: Any
    inputs: Dict[str, Any] = field(default_factory=dict)


def _torch_seed(seed: int) -> int:
    return int(seed) % (2**63)


def make_inputs(cfg: Dict, seed: int, device: str) -> Dict[str, Any]:
    """What the harness makes from the seed, for both sides."""
    if cfg["kind"] != "synthetic_hybrid":
        raise ValueError(f"unknown configuration kind {cfg['kind']!r}")
    terms, lengths = generate.zipf_corpus(seed, cfg["corpus"])
    dense, r = cfg["dense"], cfg["router"]
    gen = torch.Generator(device=device).manual_seed(_torch_seed(seed))
    table = (torch.randn((dense["buckets"], dense["dim"]), generator=gen, device=device)
             / math.sqrt(dense["dim"])).to(torch.bfloat16)
    width = 7 if r["config"]["feature_set"] == "pool7" else 3
    dims = [width] + [r["config"]["hidden_dim"]] * (r["config"]["num_layers"] - 1) + [1]
    weights = []
    for d_in, d_out in zip(dims, dims[1:]):
        w = torch.randn((d_out, d_in), generator=gen, device=device) / math.sqrt(d_in)
        weights.append((w.t().double().cpu(), torch.zeros(d_out, dtype=torch.float64)))
    inputs = {"terms": terms, "lengths": lengths, "table": table,
              "router": {"weights": weights, "stats": dict(r["stats"]), "config": r["config"]}}
    calibrate_router(cfg, inputs, seed, device)
    return inputs


def calibrate_router(cfg: Dict, inputs: Dict, seed: int, device: str) -> None:
    """Set the router's output bias so that the median of ``router_warm``
    queries drawn from the seed has a mean gate of 0.5: the reference's
    union pools and the router's hidden layer, in float64, and the bias
    rounded to float32, as the port stores it."""
    from benchmark.reference import fusion
    from benchmark.reference.system import Reference

    queries = generate.span_queries(seed, "router_warm", inputs["terms"], inputs["lengths"],
                                    cfg["router"]["warm_queries"], cfg["queries"]["length"])[1]
    ref = Reference(cfg, inputs, device)
    _, bcol, dcol = ref.union(queries)
    z = (fusion.hidden(ref.router, bcol, dcol) @ ref.router.out[0])[..., 0]
    del ref, bcol, dcol
    lo, hi = -float(z.max()) - 50.0, -float(z.min()) + 50.0
    for _ in range(100):
        mid = (lo + hi) / 2
        if float(torch.sigmoid(z + mid).mean(-1).median()) > 0.5:
            hi = mid
        else:
            lo = mid
    bias = torch.tensor([(lo + hi) / 2], dtype=torch.float32).double()
    inputs["router"]["weights"][-1] = (inputs["router"]["weights"][-1][0], bias)
    if device == "cuda":
        torch.cuda.empty_cache()


def build(cfg: Dict, inputs: Dict, seed: int, device: str) -> Deployment:
    """The port's system under test over ``inputs``."""
    return _synthetic_hybrid(cfg, inputs, seed, device)


def _bm25_config(cfg: Dict):
    from rag_uq_tpu_torch.core.config import BM25Config

    b = cfg["bm25"]
    return BM25Config(k1=b["k1"], b=b["b"], idf_epsilon=b["idf_epsilon"],
                      dense_tier_threshold=b["dense_tier_threshold"],
                      max_dense_tier_rows=b["max_dense_tier_rows"],
                      impact_budget_bytes=b["impact_budget_bytes"],
                      impact_dtype=b["impact_dtype"], max_query_terms=b["max_query_terms"])


def _synthetic_hybrid(cfg: Dict, inputs: Dict, seed: int, device: str) -> Deployment:
    from rag_uq_tpu_torch.core.types import Document
    from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder
    from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

    terms, lengths = inputs["terms"], inputs["lengths"]
    texts = generate.passage_texts(terms, lengths)
    docs = [Document(str(i), t) for i, t in enumerate(texts)]
    dense = cfg["dense"]
    embedder = NgramHashEmbedder(dim=dense["dim"], buckets=dense["buckets"],
                                 max_len=dense["max_len"], table=inputs["table"], device=device)
    retriever = HybridRetriever(embedder=embedder, bm25_config=_bm25_config(cfg), device=device)
    retriever.bm25_index.add_documents(docs)

    # The passages' features hashed in bulk (the embedder hashes in Python),
    # checked against the embedder's own hashing on a sample.
    feats, counts = ref_text.bulk_term_features(terms, lengths, cfg["corpus"]["vocab"],
                                                dense["buckets"], dense["max_len"])
    sample = generate.rng(seed, "feature_check").choice(len(docs), size=min(64, len(docs)),
                                                        replace=False)
    ids, lens = embedder._hash_batch([texts[i] for i in sample])
    if not (np.array_equal(lens, counts[sample]) and np.array_equal(ids, feats[sample])):
        raise RuntimeError("bulk passage features differ from the embedder's hashing")
    vecs = np.empty((len(docs), dense["dim"]), dtype=np.float32)
    for lo in range(0, len(docs), 4096):
        hi = min(lo + 4096, len(docs))
        vecs[lo:hi] = embedder.encode_device(
            torch.from_numpy(feats[lo:hi].astype(np.int32)),
            torch.from_numpy(counts[lo:hi].astype(np.int32))).cpu().numpy()
    retriever.dense_index.add_precomputed(docs, vecs)

    router = port_router(inputs["router"], device)
    retriever._fused_state()
    return Deployment(cfg, retriever, router, inputs=inputs)


def port_router(r: Dict, device: str):
    """The port's ``RetrievalRouter`` of the configured recipe, holding the
    harness's weights and the stated score statistics."""
    from rag_uq_tpu_torch.core.config import RouterConfig
    from rag_uq_tpu_torch.router.model import RetrievalRouter

    router = RetrievalRouter(RouterConfig(**r["config"]), device=device)
    with torch.no_grad():
        for layer, (w, bias) in zip([*router.module.hidden, router.module.out], r["weights"]):
            layer.weight.copy_(w.t().float())
            layer.bias.copy_(bias.float())
        for name, value in r["stats"].items():
            getattr(router.module, name).fill_(value)
        router.module.initialized.fill_(1.0)
    return router
