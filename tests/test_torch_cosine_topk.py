"""The dense pool kernel's wrapper (``ops/cosine_topk.py``) on the CPU.

Its choice of kernel configuration is a plain function of (dtype, k),
checked against the shared-memory formula of ``csrc/cosine_topk.cu``; its
CPU route (the plain twin) is held to the JAX package for fp16 and f32
corpora and for pools above 128, against ``cosine_topk_single`` and the
Pallas kernel in interpret mode.

The large-k path's wrapper logic (the padded score stride and the query
chunks by it) is checked against the kernel source, and its select rule,
mirrored below in torch step by step (bins over [min, max], the bin b* of
the k-th value, the rows above it, the best of its candidates, rank
order), is held to the JAX ``cosine_topk_single`` exactly on seeded rows
whose k-th value sits among many ties.

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
    src = ck.SOURCE.read_text() + ck.SOURCE.with_name("hopper_tile.cuh").read_text()
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


@pytest.mark.parametrize("live", [0, 1, 31, 32, 33, 1001, 99_999, 100_000])
def test_score_stride_pads_rows_to_128_bytes(live):
    """The large-k score rows start 128-byte aligned: ld is live rounded up
    to 32 floats (at least 32), as the kernels require (ld % 32 == 0)."""
    ld = ck.score_stride(live)
    assert ld % 32 == 0 and ld >= live and ld - max(live, 1) < 32
    src = ck.SOURCE_LARGE.read_text()
    assert "ld % 32 != 0" in src  # the C entry points refuse another stride


def test_large_chunks_use_the_padded_stride(monkeypatch):
    """The queries are chunked by the padded row: 300 queries of 1001 live
    rows (ld 1024) fill a budget of 300 padded rows exactly, and the main
    shape stays one chunk."""
    monkeypatch.setattr(ck, "SCORE_BUDGET", 4 * ck.score_stride(1001) * 300)
    assert ck.large_chunk(2048, 1001) == 300
    monkeypatch.setattr(ck, "SCORE_BUDGET", 4 * 1001 * 300)  # unpadded rows: fewer fit
    assert ck.large_chunk(2048, 1001) == 4 * 1001 * 300 // (4 * 1024)
    monkeypatch.undo()
    assert ck.score_stride(100_000) == 100_000
    assert ck.large_chunk(2048, 100_000) == 2048


SELECT_BINS = 4096  # the large-k select's histogram bins (NB in the .cu)


def select_bins(row: torch.Tensor) -> torch.Tensor:
    """The large-k select's bin of every score of one f32 row, as the kernel
    computes it: ``min(NB - 1, floor((s - min) * (NB / (max - min))))``, each
    step a correctly rounded f32 operation, so it is monotone in s; every
    score is in bin 0 when max == min."""
    row = row.float()
    mx, mn = row.max(), row.min()
    if not bool(mx > mn):
        return torch.zeros(row.shape, dtype=torch.int64)
    scale = torch.tensor(float(SELECT_BINS), dtype=torch.float32) / (mx - mn)
    t = torch.nan_to_num((row - mn) * scale, nan=0.0)
    return t.clamp(max=SELECT_BINS - 1).floor().to(torch.int64)


def split_at_kth(bins: torch.Tensor, k: int):
    """(b*, above, candidates): the bin that holds the k-th largest score,
    the count of rows in higher bins and the count in b*, from the
    histogram of ``bins`` (requires k <= len(bins))."""
    hist = torch.bincount(bins, minlength=SELECT_BINS)
    from_top = hist.flip(0).cumsum(0).flip(0)  # rows in bins >= b
    bstar = int(torch.nonzero(from_top >= k).max())
    return bstar, int(from_top[bstar] - hist[bstar]), int(hist[bstar])


def large_select_plain(scores: torch.Tensor, k: int):
    """The large-k select's steps in plain PyTorch, one query row at a time:
    bins, b*, the rows above b* and the best of b*'s candidates (value
    descending, lowest row among ties), then rank order. Scores of -0.0 read
    as +0.0, as the kernel stores them."""
    n_q, live = scores.shape
    n_out = min(k, live)
    vals = torch.full((n_q, k), float("-inf"), dtype=torch.float32)
    idx = torch.full((n_q, k), -1, dtype=torch.int32)
    for b in range(n_q):
        row = scores[b].float() + 0.0
        sel = torch.arange(live)
        if live > k:
            bins = select_bins(row)
            bstar, above, _ = split_at_kth(bins, k)
            cand = torch.nonzero(bins == bstar).flatten()  # row order
            order = torch.sort(row[cand], descending=True, stable=True).indices
            sel = torch.cat([torch.nonzero(bins > bstar).flatten(), cand[order[: k - above]]])
        order = torch.sort(row[sel], descending=True, stable=True).indices
        sel = sel[order][:n_out]
        vals[b, :n_out], idx[b, :n_out] = row[sel], sel.to(torch.int32)
    return vals, idx


def test_select_constants_match_the_kernel_source():
    src = ck.SOURCE_LARGE.read_text()
    assert int(re.search(r"constexpr int NB = (\d+);", src).group(1)) == SELECT_BINS


def _select_rows(rng, kind, n_q, live):
    """Seeded f32 score rows of one kind."""
    if kind == "random":
        return rng.normal(0.0, 0.036, size=(n_q, live)).astype(np.float32)
    if kind == "one_octave":  # every score in [0.0625, 0.125)
        return rng.uniform(0.0625, 0.125, size=(n_q, live)).astype(np.float32)
    if kind == "all_equal":
        return np.full((n_q, live), 0.25, dtype=np.float32)
    if kind == "two_valued":  # one row in 7 high, one query the other way round
        rows = np.where(np.arange(live) % 7 == 0, 0.5, -0.25).astype(np.float32)
        return np.stack([rows if i % 2 == 0 else -rows for i in range(n_q)])
    if kind == "clustered":  # a few values, each on many rows, and signed zeros
        vals = np.array([0.1, 0.1 + 2**-20, -0.0, 0.0, 0.3], dtype=np.float32)
        return vals[rng.integers(0, len(vals), size=(n_q, live))]
    raise ValueError(kind)


def _jax_topk_of_scores(scores, k):
    """The JAX cosine_topk_single on a corpus whose products are `scores`
    exactly: query b is the b-th unit vector, corpus row n holds scores[:, n]
    (every other product is zero, so each sum is the one score); rows past
    live are masked capacity."""
    n_q, live = scores.shape
    dim = -(-n_q // 8) * 8
    emb = np.zeros((max(live, k), dim), dtype=np.float32)
    emb[:live, :n_q] = scores.T
    q = np.eye(n_q, dim, dtype=np.float32)
    v, i = jax_topk.cosine_topk_single(jnp.asarray(emb), jnp.asarray(q), jnp.int32(live), k)
    return np.asarray(v), np.asarray(i)


SELECT_CASES = [
    # (kind, live, k)
    ("random", 3000, 257),
    ("random", 3000, 1000),
    ("one_octave", 4096, 300),
    ("all_equal", 2000, 500),
    ("two_valued", 2100, 257),
    ("two_valued", 2100, 1000),
    ("clustered", 2500, 700),
    ("random", 600, 600),  # k = live
    ("random", 500, 700),  # k > live
]


@pytest.mark.parametrize("case", SELECT_CASES,
                         ids=[f"{c[0]}-live{c[1]}-k{c[2]}" for c in SELECT_CASES])
def test_large_select_rule_matches_jax(rng, case):
    """The large-k select's steps (bins, b*, above, the candidates of b*,
    rank order), mirrored in torch, give the JAX top-k exactly, values and
    rows, on rows that put the k-th value in one bin with many ties."""
    kind, live, k = case
    scores = _select_rows(rng, kind, 4, live)
    tv, ti = large_select_plain(torch.from_numpy(scores), k)
    jv, ji = _jax_topk_of_scores(scores, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    if live > k:
        for row in scores:
            bins = select_bins(torch.from_numpy(row))
            bstar, above, cand = split_at_kth(bins, k)
            assert above < k <= above + cand
            assert above == int((bins > bstar).sum()) and cand == int((bins == bstar).sum())


def test_select_bins_are_monotone_and_split_one_octave(rng):
    """The bin rule is non-decreasing in the score, puts max in the top bin
    and min in bin 0, and separates scores inside one octave, where the
    first 8-bit digit of the ordered float does not."""
    row = torch.from_numpy(np.sort(_select_rows(rng, "one_octave", 1, 100_000)[0]))
    bins = select_bins(row)
    assert bool((bins[1:] >= bins[:-1]).all())
    assert int(bins[0]) == 0 and int(bins[-1]) == SELECT_BINS - 1
    assert bins.unique().numel() > SELECT_BINS * 0.9
    top_byte = (row.view(torch.int32) >> 24).unique()
    assert top_byte.numel() == 1
    assert int(select_bins(torch.full((10,), 0.5)).max()) == 0  # max == min: bin 0


def test_large_pass_wrappers_refuse_cpu_tensors_before_building(monkeypatch):
    def refuse():
        raise AssertionError("the kernels must not be built for a CPU tensor")

    monkeypatch.setattr(ck, "build_large", refuse)
    emb = torch.zeros((64, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ck.large_score_pass(emb, emb[:2], 64)
    with pytest.raises(ValueError, match="CUDA"):
        ck.large_select_pass(torch.zeros((2, 64)), torch.zeros((2, 2), dtype=torch.int32), 64, 300)
