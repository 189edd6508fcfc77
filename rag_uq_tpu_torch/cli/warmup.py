"""Warmup: the counterpart of ``rag_uq_tpu/cli/warmup.py``.

Pays the port's one-time costs before the first query: it builds both
kernel libraries (``nvcc``, one process each, started together) and the
native tokenizer (g++), then runs the fused hybrid query at the serving
batch sizes, one router train step and, with ``with_llm``, one TinyLM
generate on the device (which also loads cuBLAS and fills the caching
allocator). Reports the seconds of each.

Run: ``python3 -m rag_uq_tpu_torch.cli.warmup [--with-llm] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rag_uq_tpu_torch.cli.profile_fused import DenseRows
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.types import Document
from rag_uq_tpu_torch.index.sparse import BM25Index
from rag_uq_tpu_torch.llm.tiny_lm import TinyLM
from rag_uq_tpu_torch.native import is_available
from rag_uq_tpu_torch.ops import cosine_topk
from rag_uq_tpu_torch.retrieval.fused import (
    build_index_state,
    encode_for_fused,
    make_fused_hybrid_query,
)
from rag_uq_tpu_torch.router.model import RetrievalRouter
from rag_uq_tpu_torch.router.train import RouterTrainer
from rag_uq_tpu_torch.utils.profiling import device_sync

logger = logging.getLogger(__name__)


def warmup(
    batch_sizes: Sequence[int] = (256, 1024),
    corpus_rows: int = 4096,
    dim: int = 768,
    with_llm: bool = False,
    device: DeviceLike = "cuda",
) -> dict:
    dev = resolve_device(device)
    report = {"device": str(dev)}
    if dev.type == "cuda":
        t0 = time.time()
        cosine_topk.build_all()
        report["kernels_build_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    report["native"] = bool(is_available())
    report["native_build_s"] = round(time.time() - t0, 2)

    rng = np.random.default_rng(0)
    vocab = [f"t{i}" for i in range(2000)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(10, 40))))
             for _ in range(corpus_rows)]
    bm25 = BM25Index(device=dev)
    bm25.add_documents([Document(str(i), t) for i, t in enumerate(texts)])
    gen = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((corpus_rows, dim), generator=gen, device=dev)
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    state = build_index_state(DenseRows(emb, corpus_rows), bm25)
    router = RetrievalRouter(device=dev)
    fused = make_fused_hybrid_query(router_module=router.module, k=10, pool=50,
                                    beam=bm25._device["beam"])
    for bsz in batch_sizes:
        q = torch.randn((bsz, dim), generator=gen, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        qterms = encode_for_fused(bm25, [" ".join(rng.choice(vocab, 6)) for _ in range(bsz)])
        t0 = time.time()
        device_sync(fused(state, q, qterms))
        report[f"fused_first_b{bsz}_s"] = round(time.time() - t0, 2)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        RouterTrainer(router, checkpoint_dir=tmp).train_epoch(
            (rng.normal(size=(16, 20)).astype(np.float32),
             rng.normal(size=(16, 20)).astype(np.float32),
             rng.uniform(size=(16, 20)).astype(np.float32)))
    device_sync(router.module.out.weight)
    report["train_step_first_s"] = round(time.time() - t0, 2)

    if with_llm:
        t0 = time.time()
        TinyLM(device=dev).generate("warmup", max_tokens=8, seed=0)
        report["sampler_first_s"] = round(time.time() - t0, 2)

    logger.info("Warmup complete: %s", report)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Pay the one-time costs before serving")
    parser.add_argument("--with-llm", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(warmup(with_llm=args.with_llm, device=args.device), indent=2))


if __name__ == "__main__":
    main()
