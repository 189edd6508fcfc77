"""The dense pool kernel's wrapper (``ops/cosine_topk.py``) on the CPU.

Its choice of kernel configuration is a plain function of (dtype, k),
checked against the shared-memory formula of ``csrc/cosine_topk.cu``; its
CPU route (the plain twin) is held to the JAX package for fp16 and f32
corpora and for pools above 128, against ``cosine_topk_single`` and the
Pallas kernel in interpret mode.

Tolerances: values within 1e-6 against ``cosine_topk_single`` (both take
f32 sums of the same products, in other orders) with equal indices; within
1e-3 against the Pallas kernel, which rounds the query to the corpus dtype
and sums in its own order, with indices under the tie rule.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rag_uq_tpu.ops import topk as jax_topk
from rag_uq_tpu.ops.pallas_topk import pallas_cosine_topk
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement
from rag_uq_tpu_torch.core.config import DenseIndexConfig
from rag_uq_tpu_torch.index.dense import _DTYPES
from rag_uq_tpu_torch.ops import cosine_topk as ck

_JNP = {torch.float16: jnp.float16, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _mk(rng, cap, dim, bsz):
    emb = rng.normal(size=(cap, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.normal(size=(bsz, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def _cu_constant(name):
    src = ck.SOURCE.read_text()
    return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))


def test_config_constants_match_the_kernel_source():
    assert _cu_constant("MAX_K") == ck.MAX_K
    assert _cu_constant("BN") == ck._ROW_TILE
    assert _cu_constant("BOX_BYTES") == ck._BOX_BYTES
    assert _cu_constant("MAX_STAGES") == ck._MAX_STAGES
    assert _cu_constant("SMEM_LIMIT") == ck.SMEM_LIMIT
    assert _cu_constant("SCRATCH") * 8 == ck._SCRATCH_BYTES


def test_smem_formula_matches_the_kernel_comment():
    """The .cu comment's formula, term by term, at two configurations."""
    for bq, k, stages in [(128, 50, 5), (64, 256, 3)]:
        by_comment = 1024 + stages * (bq + 128) * 128 + bq * (k | 1) * 8 + (bq // 16) * 128 * 8 \
            + stages * 16
        assert ck.smem_bytes(bq, k, stages) == by_comment


@pytest.mark.parametrize("dtype_name", sorted(_DTYPES))
def test_every_dtype_and_k_gets_a_config_that_fits(dtype_name):
    assert dtype_name in {"bfloat16", "float16", "float32"}
    DenseIndexConfig(dtype=dtype_name)  # every dtype the index accepts
    dtype = _DTYPES[dtype_name]
    seen = set()
    for k in range(1, ck.MAX_K + 1):
        cfg = ck.kernel_config(dtype, k)
        assert cfg.query_tile in (64, 128)
        assert 2 <= cfg.stages <= ck._MAX_STAGES
        assert cfg.smem_bytes == ck.smem_bytes(cfg.query_tile, k, cfg.stages)
        assert cfg.smem_bytes <= 232_448
        # one more stage would not fit, unless the ring is already at its most
        assert cfg.stages == ck._MAX_STAGES or \
            ck.smem_bytes(cfg.query_tile, k, cfg.stages + 1) > 232_448
        seen.add(cfg.query_tile)
    assert seen == {64, 128}
    assert ck.kernel_config(dtype, 50).query_tile == 128  # the main path's pool


def test_config_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=str(ck.MAX_K)):
        ck.kernel_config(torch.bfloat16, ck.MAX_K + 1)
    with pytest.raises(ValueError):
        ck.kernel_config(torch.bfloat16, 0)
    with pytest.raises(TypeError):
        ck.kernel_config(torch.float64, 50)


CASES = [
    # (dtype, cap, dim, bsz, size, k)
    (torch.float16, 512, 32, 6, 450, 8),
    (torch.float32, 512, 32, 6, 450, 8),
    (torch.float16, 256, 16, 3, 5, 8),
    (torch.float32, 256, 16, 3, 5, 8),
    (torch.bfloat16, 512, 16, 4, 400, 150),
    (torch.float16, 512, 16, 4, 512, 256),
    (torch.float32, 512, 16, 4, 300, 256),
]


def _ids(c):
    return f"{str(c[0]).split('.')[-1]}-size{c[4]}-k{c[5]}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_wrapper_matches_jax_single(rng, case):
    dtype, cap, dim, bsz, size, k = case
    emb, q = _mk(rng, cap, dim, bsz)
    e = torch.from_numpy(emb).to(dtype)
    jv, ji = jax_topk.cosine_topk_single(
        jnp.asarray(e.float().numpy(), dtype=_JNP[dtype]), jnp.asarray(q), jnp.int32(size), k
    )
    tv, ti = ck.cuda_cosine_topk(e, torch.from_numpy(q), size, k)
    jv, ji = np.asarray(jv, dtype=np.float32), np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(np.isneginf(tv.numpy()), np.isneginf(jv))
    live = np.isfinite(jv)
    np.testing.assert_allclose(tv.numpy()[live], jv[live], atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_wrapper_matches_pallas_interpret(rng, case):
    dtype, cap, dim, bsz, size, k = case
    emb, q = _mk(rng, cap, dim, bsz)
    e = torch.from_numpy(emb).to(dtype)
    pv, pi = pallas_cosine_topk(
        jnp.asarray(e.float().numpy(), dtype=_JNP[dtype]), jnp.asarray(q), jnp.int32(size),
        k=k, block=256 if k > 128 else 128, interpret=True,
    )
    tv, ti = ck.cuda_cosine_topk(e, torch.from_numpy(q), size, k)
    pv, pi = np.asarray(pv), np.asarray(pi)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(pv))
    live = np.isfinite(pv)
    np.testing.assert_allclose(tv[live], pv[live], atol=1e-3, rtol=0)
    agree = tie_aware_agreement(tv, ti, pv, pi, rtol=0, atol=1e-3)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"]


def test_merge_pass_refuses_cpu_tensors_before_building(monkeypatch):
    def refuse():
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(ck, "build", refuse)
    part_v = torch.zeros((2, 3, 4), dtype=torch.float32)
    part_i = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ck.merge_pass(part_v, part_i, 4)


def test_large_k_constants_and_query_chunks():
    """The large-k kernels' limit matches their source; the query chunks
    keep the [chunk, live] f32 score buffer within SCORE_BUDGET and cover
    every query."""
    src = ck.SOURCE_LARGE.read_text()
    assert int(re.search(r"constexpr int LARGE_MAX_K = (\d+);", src).group(1)) == ck.LARGE_MAX_K
    assert ck.LARGE_MAX_K == 8192 > ck.MAX_K
    for n_q, live in [(2048, 100_000), (2048, 0), (1, 10**6), (5000, 2**20), (3, 7)]:
        chunk = ck.large_chunk(n_q, live)
        assert 1 <= chunk <= n_q
        assert chunk == 1 or chunk * 4 * live <= ck.SCORE_BUDGET
    assert ck.large_chunk(2048, 100_000) == 2048  # the main shape is one chunk


@pytest.mark.parametrize("k", [ck.MAX_K + 1, 1000])
def test_large_k_cpu_route_matches_jax(rng, k):
    """Above MAX_K the CPU route is the plain twin, held to the JAX
    cosine_topk_single (bf16 corpus: values within 1e-6, indices equal)."""
    emb, q = _mk(rng, 1024, 24, 3)
    e = torch.from_numpy(emb).bfloat16()
    jv, ji = jax_topk.cosine_topk_single(
        jnp.asarray(e.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(q), jnp.int32(900), k
    )
    tv, ti = ck.cuda_cosine_topk(e, torch.from_numpy(q), 900, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    live = np.isfinite(np.asarray(jv))
    np.testing.assert_allclose(tv.numpy()[live], np.asarray(jv)[live], atol=1e-6, rtol=0)
