"""The port's retrieval of the answer fixture's contexts against the JAX
package's, on the CPU.

``tests/data/torch_answer_fixture.json`` holds the top passage that the JAX
server (``QueryService`` with the demo run's encoder and router over its
5,000-passage corpus) serves for each of 32 questions. Here both packages'
``QueryService``s answer the same 32 questions. With the encoder and the
dense index in float32 they serve the same ten passages in the same order
for every question. At the checkpoint's bf16 the two packages round the
encoder's layers in another order; each question where the top passage
then differs must be an adjacent swap of two passages whose router-gated
scores lie closer than the two packages' dense scores drift apart. The
test's report (``pytest -s``) lists those gaps.
"""

import dataclasses
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from rag_uq_tpu.embed.train import load_encoder_checkpoint as jax_load_encoder_checkpoint

FIXTURE = Path(__file__).parent / "data" / "torch_answer_fixture.json"
RUN = "runs/demo_full_r4"


def _pools_and_hits(jax_side, dtype, questions):
    """One package's QueryService over the demo index with the encoder and
    the dense index at ``dtype``: (top-10 doc ids per question, the fused
    query's pools (bm25 values, ids, dense values, ids) as numpy)."""
    if jax_side:
        import jax

        import rag_uq_tpu.retrieval.fused as fused
        from rag_uq_tpu.cli.serve import QueryService
        from rag_uq_tpu.core.config import DenseIndexConfig
        from rag_uq_tpu.core.types import Document
        from rag_uq_tpu.embed.encoder import TransformerEmbedder
        from rag_uq_tpu.retrieval.hybrid import HybridRetriever
        from rag_uq_tpu.router.model import RetrievalRouter
        from rag_uq_tpu.router.train import RouterTrainer

        saved = jax_load_encoder_checkpoint(f"{RUN}/encoder/encoder.msgpack")
        encoder = TransformerEmbedder(dataclasses.replace(saved.config, dtype=dtype))
        encoder.load_params(saved.params)
        kw, router = {}, RetrievalRouter()
        RouterTrainer(router).load_checkpoint(f"{RUN}/router/best_router.msgpack")
    else:
        import rag_uq_tpu_torch.retrieval.fused as fused
        from rag_uq_tpu_torch.cli.serve import QueryService
        from rag_uq_tpu_torch.core.config import DenseIndexConfig
        from rag_uq_tpu_torch.core.types import Document
        from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
        from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
        from rag_uq_tpu_torch.router.model import RetrievalRouter
        from rag_uq_tpu_torch.router.train import load_router_checkpoint
        from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

        path = f"{RUN}/encoder/encoder.msgpack"
        with open(path + ".json") as f:
            config = EncoderConfig(**{**json.load(f)["encoder_config"], "dtype": dtype})
        encoder = TransformerEmbedder(config, device="cpu")
        encoder.load_params(load_flax_checkpoint(path))
        kw, router = {"device": "cpu"}, RetrievalRouter(device="cpu")
        load_router_checkpoint(router, f"{RUN}/router/best_router.msgpack")
    with open(f"{RUN}/corpus.jsonl") as f:
        docs = [Document.from_dict(json.loads(line)) for line in f]
    retriever = HybridRetriever(embedder=encoder, **kw,
                                dense_config=DenseIndexConfig(embedding_dim=256, dtype=dtype))
    retriever.add_documents(docs)
    pools = []
    original = fused.fuse_pools_select

    def capture(bvals, bidx, dvals, didx, k, **options):
        if jax_side:
            jax.debug.callback(lambda *a: pools.append([np.asarray(x) for x in a]),
                               bvals, bidx, dvals, didx)
        else:
            pools.append([x.numpy().copy() for x in (bvals, bidx, dvals, didx)])
        return original(bvals, bidx, dvals, didx, k, **options)

    service = QueryService(retriever, router=router, max_batch=len(questions))
    try:
        with mock.patch.object(fused, "fuse_pools_select", capture):
            hits = service.search(list(questions), 10)
            if jax_side:
                jax.effects_barrier()
    finally:
        service.close()
    assert len(pools) == 1 and len(pools[0][0]) == len(questions)
    return [[h["doc_id"] for h in row] for row in hits], pools[0]


def _gated_scores(pools, q, router):
    """The router-gated score of every head member of question ``q``'s
    pools, by the port's rule: {doc position: score}."""
    from rag_uq_tpu_torch.retrieval import fused

    b, bi, d, di = (torch.from_numpy(np.array(x[q:q + 1])) for x in pools)
    positions, bm25, dense = fused.merge_pools(b, bi, d, di)
    head, gated, _ = fused.router_head_scores(bm25, dense, positions >= 0,
                                              router.trained_num_passages, router.module)
    return dict(zip(torch.gather(positions, -1, head)[0].tolist(), gated[0].tolist()))


def _dense_drift(a, b):
    """Max |dense score| difference between two pools over the passages in both."""
    out = 0.0
    for q in range(len(a[2])):
        x = {int(i): float(v) for i, v in zip(a[3][q], a[2][q]) if i >= 0}
        y = {int(i): float(v) for i, v in zip(b[3][q], b[2][q]) if i >= 0}
        out = max([out] + [abs(x[i] - y[i]) for i in x.keys() & y.keys()])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demo_retrieval_matches_jax(dtype):
    """The port's QueryService (demo encoder, router and corpus) against the
    JAX package's on the fixture's 32 questions, on the CPU. In float32 the
    served top 10 are the same passages in the same order. At bf16 the
    encoder's roundings differ between the packages; a top passage that
    differs must be the other side's second, and the two passages' gated
    scores (on either side's pools) must lie closer than the packages'
    dense scores drift apart, so the flip is a rounding tie."""
    from rag_uq_tpu_torch.router.model import RetrievalRouter
    from rag_uq_tpu_torch.router.train import load_router_checkpoint

    fx = json.loads(FIXTURE.read_text())
    questions = fx["questions"]
    ours, our_pools = _pools_and_hits(False, dtype, questions)
    ref, ref_pools = _pools_and_hits(True, dtype, questions)
    if dtype == "float32":
        assert ours == ref
        return
    with open(f"{RUN}/corpus.jsonl") as f:
        rows = [json.loads(line) for line in f]
    texts = {r["id"]: r["text"] for r in rows}
    position = {r["id"]: p for p, r in enumerate(rows)}
    assert [texts[r[0]] for r in ref] == fx["contexts"]
    router = RetrievalRouter(device="cpu")
    load_router_checkpoint(router, f"{RUN}/router/best_router.msgpack")
    drift = _dense_drift(our_pools, ref_pools)
    flips = [q for q in range(len(questions)) if ours[q][0] != ref[q][0]]
    print(f"\nbf16: top passage equal on {len(questions) - len(flips)} of {len(questions)}; "
          f"max dense drift between the packages {drift:.6f}")
    for q in flips:
        a, b = ours[q][0], ref[q][0]
        assert ours[q][1] == b and ref[q][1] == a, (q, ours[q][:3], ref[q][:3])
        pa, pb = position[a], position[b]
        gaps = []
        for name, pools in (("port", our_pools), ("jax", ref_pools)):
            g = _gated_scores(pools, q, router)
            dense = {int(i): float(v) for i, v in zip(pools[3][q], pools[2][q])}
            gaps.append(abs(g[pa] - g[pb]))
            print(f"  q{q} {name} pools: gated {a} {g[pa]:.6f} {b} {g[pb]:.6f} "
                  f"(gap {gaps[-1]:.2e}); dense {dense[pa]:.6f} {dense[pb]:.6f}")
        assert max(gaps) < drift, (q, gaps, drift)
