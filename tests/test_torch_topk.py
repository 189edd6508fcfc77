"""The port's cosine top-k (plain twins and the kernel wrapper on the CPU)
against the JAX package's exact ops and the Pallas kernel in interpret mode.

Tolerances: f32 corpora compare values within 1e-6 absolute (the two
products sum in different orders) and indices exactly; bf16 corpora compare
values within 1e-3 and indices under the tie rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rag_uq_tpu.ops import topk as jax_topk
from rag_uq_tpu.ops.pallas_topk import pallas_cosine_topk
from rag_uq_tpu_torch.cli.bench_sharded import tie_aware_agreement
from rag_uq_tpu_torch.ops import cosine_topk as ck
from rag_uq_tpu_torch.ops import topk as torch_topk


def _mk(rng, cap, dim, bsz):
    emb = rng.normal(size=(cap, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.normal(size=(bsz, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def _ties():
    emb = np.tile(np.eye(8, dtype=np.float32), (8, 1))  # rows repeat
    return emb, np.eye(8, dtype=np.float32)[:3]


CASES = {
    # name: (cap, dim, bsz, size, k)
    "partial": (512, 32, 6, 450, 8),
    "size_lt_k": (256, 16, 3, 5, 8),
    "empty": (128, 16, 2, 0, 4),
    "full": (256, 32, 4, 256, 6),
}


def _case(rng, name):
    if name == "ties":
        emb, q = _ties()
        return emb, q, 64, 6
    cap, dim, bsz, size, k = CASES[name]
    emb, q = _mk(rng, cap, dim, bsz)
    return emb, q, size, k


def _assert_same(tv, ti, jv, ji, atol):
    tv, ti = tv.float().numpy(), ti.numpy()
    jv, ji = np.asarray(jv, dtype=np.float32), np.asarray(ji)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    live = np.isfinite(jv)
    np.testing.assert_allclose(tv[live], jv[live], atol=atol, rtol=0)


@pytest.mark.parametrize("name", [*CASES, "ties"])
def test_single_and_wrapper_match_jax_f32(rng, name):
    emb, q, size, k = _case(rng, name)
    jv, ji = jax_topk.cosine_topk_single(
        jnp.asarray(emb), jnp.asarray(q), jnp.int32(size), k
    )
    for fn in (torch_topk.cosine_topk_single, ck.cosine_topk_plain):
        tv, ti = fn(torch.from_numpy(emb), torch.from_numpy(q), size, k)
        _assert_same(tv, ti, jv, ji, atol=1e-6)


@pytest.mark.parametrize("name", [*CASES, "ties"])
def test_wrapper_matches_pallas_interpret_bf16(rng, name):
    emb, q, size, k = _case(rng, name)
    cap = emb.shape[0]
    block = 16 if name == "ties" else 128
    pv, pi = pallas_cosine_topk(
        jnp.asarray(emb, dtype=jnp.bfloat16), jnp.asarray(q), jnp.int32(size),
        k=k, block=min(block, cap), interpret=True,
    )
    tv, ti = ck.cuda_cosine_topk(
        torch.from_numpy(emb).to(torch.bfloat16), torch.from_numpy(q), size, k
    )
    pv, pi = np.asarray(pv), np.asarray(pi)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(pv))
    live = np.isfinite(pv)
    np.testing.assert_allclose(tv[live], pv[live], atol=1e-3, rtol=0)
    agree = tie_aware_agreement(tv, ti, pv, pi, rtol=0, atol=1e-3)
    assert agree["tie_aware_agreement"] == 1.0, agree["violations"]


@pytest.mark.parametrize("name", ["partial", "size_lt_k", "empty", "full"])
def test_block_streamed_matches_jax(rng, name):
    emb, q, size, k = _case(rng, name)
    block = 64
    jv, ji = jax_topk.cosine_topk(
        jnp.asarray(emb), jnp.asarray(q), jnp.int32(size), k, block=block
    )
    tv, ti = torch_topk.cosine_topk(
        torch.from_numpy(emb), torch.from_numpy(q), size, k, block=block
    )
    _assert_same(tv, ti, jv, ji, atol=1e-6)


def test_block_streamed_ties_keep_lowest_row():
    emb, q = _ties()
    jv, ji = jax_topk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), jnp.int32(64), 6, block=16)
    tv, ti = torch_topk.cosine_topk(torch.from_numpy(emb), torch.from_numpy(q), 64, 6, block=16)
    _assert_same(tv, ti, jv, ji, atol=0.0)


def test_bf16_storage_matches_jax(rng):
    emb, q = _mk(rng, 256, 32, 4)
    e16 = jnp.asarray(emb, dtype=jnp.bfloat16)
    jv, ji = jax_topk.cosine_topk_single(e16, jnp.asarray(q), jnp.int32(256), 6)
    tv, ti = torch_topk.cosine_topk_single(
        torch.from_numpy(np.asarray(e16, dtype=np.float32)).to(torch.bfloat16),
        torch.from_numpy(q), 256, 6,
    )
    _assert_same(tv, ti, jv, ji, atol=1e-6)


def test_merge_topk_matches_jax(rng):
    # Ties across the two sets: a wins, as the concatenation order says.
    va = np.sort(rng.integers(0, 5, size=(3, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    vb = np.sort(rng.integers(0, 5, size=(3, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    ia = rng.integers(0, 100, size=(3, 6)).astype(np.int32)
    ib = rng.integers(100, 200, size=(3, 6)).astype(np.int32)
    jv, ji = jax_topk.merge_topk(*map(jnp.asarray, (va, ia, vb, ib)), 5)
    tv, ti = torch_topk.merge_topk(*map(torch.from_numpy, (va, ia, vb, ib)), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_gather_scores_matches_jax(rng):
    emb, q = _mk(rng, 64, 16, 3)
    pos = rng.integers(-1, 64, size=(3, 7)).astype(np.int32)
    js = jax_topk.gather_scores(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(pos))
    ts = torch_topk.gather_scores(torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(pos))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def test_stable_topk_ties_to_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = torch_topk.stable_topk(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_cpu_wrapper_takes_plain_version_and_never_builds(rng, monkeypatch):
    def refuse():
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(ck, "build", refuse)
    before = ck.cuda_cosine_topk.launches
    emb, q = _mk(rng, 128, 16, 2)
    e = torch.from_numpy(emb).to(torch.bfloat16)
    tv, ti = ck.cuda_cosine_topk(e, torch.from_numpy(q), 100, 5)
    pv, pi = ck.cosine_topk_plain(e, torch.from_numpy(q), 100, 5)
    assert torch.equal(ti, pi) and torch.equal(tv, pv)
    assert ck.cuda_cosine_topk.launches == before == 0
    assert ck._lib is None


def test_wrapper_rejects_bad_k(rng):
    """k above the heap kernel's MAX_K now answers (the large-k route), as
    the JAX cosine_topk does, with the same rows (f32 corpus: values within
    1e-6, indices equal); k = 0 and k above the capacity still raise."""
    emb, q = _mk(rng, 512, 16, 2)
    e, qq = torch.from_numpy(emb), torch.from_numpy(q)
    with pytest.raises(ValueError, match="capacity=512"):
        ck.cuda_cosine_topk(e, qq, 10, 513)
    with pytest.raises(ValueError):
        ck.cuda_cosine_topk(e, qq, 10, 0)
    for size, k in ((300, ck.MAX_K), (300, ck.MAX_K + 1), (500, 512)):
        vals, idx = ck.cuda_cosine_topk(e, qq, size, k)
        jv, ji = jax_topk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), jnp.int32(size), k, 512)
        assert vals.shape == idx.shape == (2, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        live = np.isfinite(np.asarray(jv))
        np.testing.assert_allclose(vals.numpy()[live], np.asarray(jv)[live], atol=1e-6)
        assert (idx[:, :size] >= 0).all() and (idx[:, size:] == -1).all()


@pytest.mark.parametrize("k", [1, 50, 121, 128, 256])
def test_chunking_covers_live_rows(k):
    """The kernel's chunk split covers every live row exactly once, in row
    tiles, for both query tiles of kernel_config (B <= 64 or k > 121, and
    the rest), at the shapes the port's paths launch (served batches over
    20,000 rows, the evaluation chunks, the training and gloo shards, the
    parity arm, the last shard and the main shape). Its bounds: about one
    block per SM (more only where the query tiles alone exceed the SMs), at
    most MAX_CANDIDATES candidates a query, and chunks of at least 2k rows."""
    n_sm = 132
    for n_q, live in [(2048, 100_000), (1, 100_000), (3, 5), (64, 131_072), (5, 0),
                      (2047, 100_000), (20_000, 131_072),
                      (1, 20_000), (8, 20_000), (64, 20_000), (256, 20_000), (72, 5_000),
                      (128, 5_000), (512, 10_240), (512, 5_000), (800, 4_000), (2048, 1_696)]:
        query_tile = ck.kernel_config(torch.bfloat16, k, n_q).query_tile
        n_chunks, rows = ck.chunking(n_q, live, query_tile, n_sm, k)
        assert rows % 128 == 0 and n_chunks >= 1
        assert n_chunks * k <= ck.MAX_CANDIDATES
        n_qtiles = -(-n_q // query_tile)
        assert n_chunks * n_qtiles <= max(n_sm, n_qtiles)
        assert rows >= 2 * k
        assert n_chunks * rows >= live and (n_chunks - 1) * rows < max(live, 1)
        starts = [c * rows for c in range(n_chunks)]
        covered = sum(min(s + rows, live) - s for s in starts)
        assert covered == live
        plan = ck.plan(torch.bfloat16, k, n_q, live, n_sm)
        assert (plan.n_chunks, plan.chunk_rows) == (n_chunks, rows)
        assert plan.config == ck.kernel_config(torch.bfloat16, k, n_q)
    # The main shape keeps its plan: 16 query tiles of 128, 8 chunks.
    assert ck.chunking(2048, 100_000, 128, n_sm, 50) == (8, 12_544)
    # A served batch takes one 64-row query tile and about one chunk an SM.
    assert ck.chunking(1, 20_000, 64, n_sm, 50) == (79, 256)
