"""The plain reference against the port, at a tiny size on the CPU."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from benchmark import deploy
from benchmark.reference import fusion, text
from benchmark.reference.bm25 import BM25

ROOT = Path(__file__).resolve().parent.parent
BM25_CFG = {"k1": 1.5, "b": 0.75, "idf_epsilon": 0.25, "dense_tier_threshold": 4,
            "max_dense_tier_rows": 8192, "impact_budget_bytes": 2 << 30,
            "impact_dtype": "float32", "max_query_terms": 32}


def _corpus(n=200, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    docs = [rng.choice(vocab, size=int(rng.integers(5, 40)), p=p / p.sum()) for _ in range(n)]
    return docs, [" ".join(map(str, d)) for d in docs]


def test_bm25_scores_match_the_port():
    from rag_uq_tpu_torch.core.config import BM25Config
    from rag_uq_tpu_torch.core.types import Document
    from rag_uq_tpu_torch.index.sparse import BM25Index

    docs, texts = _corpus()
    index = BM25Index(config=BM25Config(dense_tier_threshold=4, impact_dtype="float32"),
                      device="cpu")
    index.add_documents([Document(str(i), t) for i, t in enumerate(texts)])
    queries = ["1 2 3", "17 17 250", "299 5", "404 0"]
    port = index.score_all_batch(queries)
    ref = BM25(docs, 300, BM25_CFG, "cpu")
    ids = [[int(t) if int(t) < 300 else -1 for t in q.split()] for q in queries]
    np.testing.assert_allclose(ref.scores(ids).numpy(), port, rtol=1e-5, atol=1e-5)


def test_bm25_stores_the_impact_matrix_terms_in_bf16():
    docs, _ = _corpus()
    exact = BM25(docs, 300, BM25_CFG, "cpu")
    stored = BM25(docs, 300, dict(BM25_CFG, impact_dtype="bfloat16"), "cpu")
    assert exact.matrix_terms == stored.matrix_terms > 0
    w = stored.w_sorted[stored.df[stored.term_sorted] > 4]
    assert torch.equal(w, w.to(torch.bfloat16).double())


def test_hash_features_and_bag_match_the_port():
    from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder

    docs, texts = _corpus(n=40)
    table = (torch.randn((4096, 64), generator=torch.Generator().manual_seed(3)) / 8.0).to(
        torch.bfloat16)
    emb = NgramHashEmbedder(dim=64, buckets=4096, max_len=32, table=table, device="cpu")
    ids, lens = emb._hash_batch(texts)
    terms = np.zeros((len(docs), max(map(len, docs))), dtype=np.int64)
    for i, d in enumerate(docs):
        terms[i, : len(d)] = d
    feats, counts = text.bulk_term_features(terms, np.array([len(d) for d in docs]), 300,
                                            4096, 32)
    assert np.array_equal(feats, ids) and np.array_equal(counts, lens)
    assert [text.ngram_features(t, 4096, 32) for t in texts[:3]] == \
        [list(ids[i, : lens[i]]) for i in range(3)]
    port = emb.encode(texts)
    tab = table.double()
    ref = np.stack([(tab[f].mean(0) / tab[f].mean(0).norm()).numpy()
                    for f in (torch.as_tensor(ids[i, : lens[i]]) for i in range(len(texts)))])
    assert (port * ref).sum(1).min() > 0.9999


def test_router_gate_and_fusion_match_the_port():
    from rag_uq_tpu_torch.retrieval.fused import fuse_pools_select

    cfg = json.loads((ROOT / "benchmark/configs/fiqa-hybrid-d768.json").read_text())["router"]
    g = torch.Generator().manual_seed(5)
    dims = [7, cfg["config"]["hidden_dim"], 1]
    weights = [((torch.randn((o, i), generator=g) / math.sqrt(i)).t().double(),
                torch.randn(o, generator=g).double() * 0.1) for i, o in zip(dims, dims[1:])]
    port = deploy.port_router({"weights": weights, "stats": cfg["stats"],
                               "config": cfg["config"]}, "cpu")
    port.module.eval()
    ref = fusion.Router(hidden=weights[:-1], out=weights[-1], stats=cfg["stats"],
                        feature_set="pool7", fuse_norm="maxnorm", gate_policy="binary")
    b, d = torch.rand((6, 20), generator=g) * 20, torch.rand((6, 20), generator=g)
    np.testing.assert_allclose(fusion.gate(ref, b.double(), d.double()).numpy(),
                               port.module(b, d).detach().numpy(), rtol=1e-5, atol=1e-6)
    # The whole fusion over two pools of 30, every column gated.
    bv, bi = torch.sort(torch.rand((8, 30), generator=g) * 20, descending=True)[0], \
        torch.randperm(400, generator=g)[:240].reshape(8, 30)
    dv, di = torch.sort(torch.rand((8, 30), generator=g), descending=True)[0], \
        torch.randperm(400, generator=g)[:240].reshape(8, 30)
    vals, pos = fuse_pools_select(bv, bi, dv, di, 10, router_module=port.module)
    cols = fusion.union_pool(dv.double(), di.long(), bv.double(), bi.long())
    r = fusion.rank(ref, *cols)
    assert bool(fusion.judge(r, pos.long(), 10, 1e-5, 1e-6).all())
    _, _, reported, ref_pos = fusion.top(r, 10)
    assert torch.equal(ref_pos, pos.long())
    np.testing.assert_allclose(reported.numpy(), vals.double().numpy(), atol=1e-5)
