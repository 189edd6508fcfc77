"""Corpus sharding with per-shard top-k merged after an all-gather: the
counterpart of ``rag_uq_tpu/parallel/sharding.py``.

The JAX package runs one ``shard_map`` program over a ``Mesh``: every chip
takes an exact top-k of its row range of the corpus, and the (score, global
id) pairs are merged after an ``all_gather`` over ICI. The port runs the same
arithmetic SPMD, one rank per shard, each rank holding its own rows on its
own device. Each searcher is two plain functions and a callable around them:

    shard body   the shard's tensors and its index -> local pools with
                 global ids (``dense_shard_topk``, ``bm25_shard_topk``,
                 ``fused_shard_pools``)
    merge        the gathered ``[S, B, k_local]`` pools -> the global pool
                 (``merge_shard_pools``; the fused query adds the replicated
                 delta and the fusion tail in ``fused_merge``)
    make_*       body on this rank -> ``gather_shards`` over the mesh ->
                 merge; the callable carries the two as ``.shard_pools`` and
                 ``.merge``, and ``run_in_process`` runs all S shards of it
                 in one process, as the tests do, with the results of S
                 ranks.

The layouts (``*_layout``) are host code that lays out the shards asked for;
the ``shard_*`` functions lay out the calling rank's shard on its device.
The two-tier layout is ``index/twotier.py::bm25_twotier_layout``, the same
function that lays out ``BM25Index`` on one device. Per-posting impacts bake
in global idf and avgdl, and the dense-term set of the two-tier layout comes
from global document frequencies, so local scores are the single-device
scores and the merge is exact. A shard's BM25 pool and the replicated
delta's merge are the single-device query's (``ops/bm25.py::twotier_pool``
and ``merge_delta_pool``).

Every shard's dense pool goes through ``retrieval/fused.py::dense_pool``:
the CUDA cosine top-k kernel for a tensor on a card, the plain twin on the
CPU. Every top-k is ``stable_topk`` (value descending, then the lowest
slot); the merge input is laid out shard-major, so ties go to the lowest
global id, as ``lax.top_k`` sends them. ``lax.approx_max_k`` has no PyTorch
counterpart, so there is no ``dense_approx`` or ``sparse_recall_target``:
every top-k is exact, and ``approx_topk`` only turns on the twotier ``lsel``
truncation, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from rag_uq_tpu_torch.core.mesh import gather_shards, mesh_device, mesh_rank
from rag_uq_tpu_torch.index.twotier import bm25_twotier_layout, local_twotier
from rag_uq_tpu_torch.ops import bm25 as bm25_ops
from rag_uq_tpu_torch.ops.topk import stable_topk
from rag_uq_tpu_torch.retrieval.fused import dense_pool, fuse_pools_select
from rag_uq_tpu_torch.router.model import RouterModule

Pools = Tuple[torch.Tensor, torch.Tensor]
_NEG = float("-inf")


# -- the merge ---------------------------------------------------------------------


def merge_shard_pools(
    vals: torch.Tensor, idx: torch.Tensor, k: int, dead_to: float = _NEG,
    positive_only: bool = False,
) -> Pools:
    """The global top-k of gathered per-shard pools ``[S, B, k_local]``.

    Dead slots become (``dead_to``, -1): those at ``-inf``, or with
    ``positive_only`` those at or below 0.0 (the BM25 contract). Fewer than
    ``k`` candidates in all are padded with dead slots.
    """
    n_shards, bsz, k_local = vals.shape
    cat_v = vals.permute(1, 0, 2).reshape(bsz, n_shards * k_local)
    cat_i = idx.permute(1, 0, 2).reshape(bsz, n_shards * k_local)
    k_out = min(k, n_shards * k_local)
    mv, sel = stable_topk(cat_v, k_out)
    mi = torch.gather(cat_i, -1, sel)
    dead = mv <= 0.0 if positive_only else torch.isneginf(mv)
    mv = torch.where(dead, dead_to, mv)
    mi = torch.where(dead, -1, mi)
    if k_out < k:
        mv = torch.nn.functional.pad(mv, (0, k - k_out), value=dead_to)
        mi = torch.nn.functional.pad(mi, (0, k - k_out), value=-1)
    return mv, mi


def _on_mesh(mesh: Optional[DeviceMesh], shard_pools: Callable, merge: Callable,
             n_merge_args: int = 0) -> Callable:
    """``fn(*args)``: this rank's body on ``args``, the all-gather, the merge
    on the gathered pools and the last ``n_merge_args`` of ``args``; with
    ``fn.shard_pools`` and ``fn.merge`` for ``run_in_process``."""

    @torch.no_grad()
    def run(*args):
        if mesh is None:
            raise ValueError("no mesh: run the shards with run_in_process")
        vals, idx = shard_pools(*args, mesh_rank(mesh))
        return merge(gather_shards(vals, mesh), gather_shards(idx, mesh),
                     *args[len(args) - n_merge_args:])

    run.shard_pools, run.merge = shard_pools, merge
    return run


@torch.no_grad()
def run_in_process(fn: Callable, shard_args: Sequence[Sequence[Any]],
                   merge_args: Sequence[Any] = ()) -> Any:
    """Run every shard of a ``make_*`` searcher in this process: shard ``s``
    gets ``shard_args[s]``, and the stacked pools go to the merge with
    ``merge_args``. The same result as S ranks on a mesh."""
    pools = [fn.shard_pools(*args, s) for s, args in enumerate(shard_args)]
    return fn.merge(torch.stack([v for v, _ in pools]), torch.stack([i for _, i in pools]),
                    *merge_args)


# -- dense ---------------------------------------------------------------------------


def shard_rows(x, n_shards: int, shard: int):
    """Rows ``[shard * cap / S, (shard + 1) * cap / S)`` of ``x``; the capacity
    must divide evenly by the number of shards."""
    cap = x.shape[0]
    if cap % n_shards:
        raise ValueError(f"capacity {cap} does not divide into {n_shards} shards")
    rows = cap // n_shards
    return x[shard * rows : (shard + 1) * rows]


def shard_corpus_matrix(emb: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a ``[cap, D]`` matrix, on its device (the local
    block of ``NamedSharding(mesh, P(CORPUS_AXIS, None))``)."""
    local = shard_rows(emb, mesh.size(), mesh_rank(mesh))
    return local.to(mesh_device(mesh)).contiguous()


def _local_size(size: int, shard: int, shard_cap: int) -> int:
    return min(max(int(size) - shard * shard_cap, 0), shard_cap)


def dense_shard_topk(
    emb_local: torch.Tensor, queries: torch.Tensor, size: int, shard: int, k: int,
    block: int = 8192,
) -> Pools:
    """One shard's exact cosine top-min(k, shard_cap) with global row ids
    (-inf / -1 dead). A shard holds at most shard_cap rows, so that many
    suffice for an exact global merge."""
    shard_cap = emb_local.shape[0]
    k_local = min(k, shard_cap)
    vals, idx = dense_pool(emb_local, queries, _local_size(size, shard, shard_cap), k_local,
                           dense_mode="stream", block=min(block, shard_cap))
    return vals, torch.where(idx >= 0, idx + shard * shard_cap, -1)


def make_sharded_dense_topk(mesh: Optional[DeviceMesh], k: int, block: int = 8192) -> Callable:
    """fn(emb_local, queries, size) -> (scores [B, k], global rows [B, k]),
    the same on every rank; -inf / -1 dead."""
    return _on_mesh(
        mesh,
        lambda emb, q, size, shard: dense_shard_topk(emb, q, size, shard, k, block),
        lambda vals, idx: merge_shard_pools(vals, idx, k),
    )


# -- BM25 CSR ------------------------------------------------------------------------


def bm25_state_layout(state: Dict[str, Any], n_shards: int,
                      shards: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """CSR postings re-bucketed by doc range (numpy, leading dim one per
    shard in ``shards``, all by default): shard s holds the postings of docs
    ``[s * dps, (s + 1) * dps)`` with local doc positions and its own indptr
    (``dps = state["docs_per_shard"]``). The posting capacity comes from the
    fullest shard of all, so every rank lays out the same shapes."""
    shards = range(n_shards) if shards is None else shards
    indptr = np.asarray(state["indptr"])
    post_doc = np.asarray(state["post_doc"])
    post_w = np.asarray(state["post_w"])
    vcap = indptr.shape[0] - 1
    n_post = int(indptr[-1])
    tids = np.repeat(np.arange(vcap, dtype=np.int32), np.diff(indptr))
    docs = post_doc[:n_post]
    ws = post_w[:n_post]
    dps = int(state["docs_per_shard"])
    shard_of = docs // dps
    max_local = max(
        int(np.max(np.bincount(shard_of, minlength=n_shards))) if n_post else 1, 1
    )
    pcap_local = 1 << (max_local - 1).bit_length()

    local_indptr = np.zeros((len(shards), vcap + 1), dtype=np.int32)
    local_doc = np.zeros((len(shards), pcap_local), dtype=np.int32)
    local_w = np.zeros((len(shards), pcap_local), dtype=np.float32)
    for j, s in enumerate(shards):
        m = shard_of == s
        t_s, d_s, w_s = tids[m], docs[m], ws[m]
        order = np.lexsort((d_s, t_s))
        t_s, d_s, w_s = t_s[order], d_s[order], w_s[order]
        counts = np.bincount(t_s, minlength=vcap)
        np.cumsum(counts, out=local_indptr[j, 1:])
        local_doc[j, : d_s.shape[0]] = d_s - s * dps
        local_w[j, : w_s.shape[0]] = w_s
    return {"indptr": local_indptr, "post_doc": local_doc, "post_w": local_w,
            "docs_per_shard": dps}


def shard_bm25_state(state: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's CSR shard (``bm25_state_layout``) as tensors on its device."""
    local = bm25_state_layout(state, mesh.size(), [mesh_rank(mesh)])
    dev = mesh_device(mesh)
    out = {name: torch.from_numpy(local[name][0]).to(dev)
           for name in ("indptr", "post_doc", "post_w")}
    out["docs_per_shard"] = local["docs_per_shard"]
    return out


def bm25_shard_topk(
    indptr_l: torch.Tensor, post_doc_l: torch.Tensor, post_w_l: torch.Tensor,
    qtids: torch.Tensor, shard: int, k: int, max_df: int, docs_per_shard: int,
) -> Pools:
    """One shard's exhaustive BM25 top-min(k, dps) with global doc ids
    (0.0 / -1 dead)."""
    scores = bm25_ops.score_all(indptr_l, post_doc_l, post_w_l, qtids, docs_per_shard, max_df)
    vals, idx = bm25_ops.topk_from_scores(scores, min(k, docs_per_shard))
    return vals, torch.where(idx >= 0, idx + shard * docs_per_shard, -1)


def make_sharded_bm25_topk(mesh: Optional[DeviceMesh], k: int, max_df: int,
                           n_docs_cap: int, n_shards: Optional[int] = None) -> Callable:
    """fn(indptr_l, post_doc_l, post_w_l, qtids) -> (scores [B, k], global
    doc positions [B, k]); positive scores only, 0.0 / -1 dead. Without a
    mesh, ``n_shards`` gives the docs a shard (``run_in_process``)."""
    dps = n_docs_cap // (mesh.size() if mesh is not None else n_shards)
    return _on_mesh(
        mesh,
        lambda ip, pd, pw, q, shard: bm25_shard_topk(ip, pd, pw, q, shard, k, max_df, dps),
        lambda vals, idx: merge_shard_pools(vals, idx, k, dead_to=0.0, positive_only=True),
    )


# -- two-tier BM25 -------------------------------------------------------------------


def shard_bm25_twotier(csr: Dict[str, Any], mesh: DeviceMesh, shard_cap: int,
                       config) -> Dict[str, Any]:
    """This rank's two-tier shard (``bm25_twotier_layout``) on its device,
    without the leading shard dim; ``term_row`` and the metadata as there."""
    return local_twotier(bm25_twotier_layout(csr, mesh.size(), shard_cap, config,
                                             [mesh_rank(mesh)], device=mesh_device(mesh)), 0)


# -- the fused query -------------------------------------------------------------------


def fused_shard_pools(
    state: Dict[str, Any], q_vecs: torch.Tensor, qterms: Dict[str, torch.Tensor],
    shard: int, *, shard_cap: int, pool: int, beam: int, approx_topk: bool,
    sparse_mode: str, lsel: int, nonneg: bool,
) -> Pools:
    """One shard's dense and BM25 top-pools with global ids, stacked
    (``[2, B, k_local]``: dense first; -inf / -1 dead).

    ``state`` holds the shard's ``emb`` rows and two-tier tensors and the
    total base ``size``. The positive-scores contract is applied before
    the merge, so dead local slots never outrank live docs of other shards.
    """
    k_local = min(pool, shard_cap)
    local_size = _local_size(state["size"], shard, shard_cap)
    dvals, didx = dense_pool(state["emb"], q_vecs, local_size, k_local)
    didx = torch.where(didx >= 0, didx + shard * shard_cap, -1)
    dvals = torch.where(didx >= 0, dvals, _NEG)

    bvals, bidx = bm25_ops.twotier_pool(
        state, qterms["qtids"], k_local, beam=beam, sparse_mode=sparse_mode,
        approx=approx_topk, lsel=lsel, nonneg=nonneg)
    blive = (bvals > 0.0) & (bidx >= 0)
    bvals = torch.where(blive, bvals, _NEG)
    bidx = torch.where(blive, bidx + shard * shard_cap, -1)
    return torch.stack([dvals, bvals]), torch.stack([didx, bidx])


def fused_merge(
    vals: torch.Tensor, idx: torch.Tensor, state: Dict[str, Any], q_vecs: torch.Tensor,
    qterms: Dict[str, torch.Tensor], *, k: int, pool: int,
    router_module: Optional[RouterModule], router_width: Optional[int],
    delta_cap: int, delta_max_df: int,
) -> Pools:
    """Merge the gathered pools ``[S, 2, B, k_local]``, fold in the
    replicated live-ingest delta, then the union merge, the fusion and the
    final top-k (``fuse_pools_select``). Returns (scores [B, k], global
    positions [B, k])."""
    dvals, didx = merge_shard_pools(vals[:, 0], idx[:, 0], pool, dead_to=0.0)
    bvals, bidx = merge_shard_pools(vals[:, 1], idx[:, 1], pool, dead_to=0.0)

    if delta_cap > 0:
        # The streaming-ingest delta is small and replicated: every rank
        # scores the recent docs exhaustively and merges them into its pools.
        k_delta = min(pool, delta_cap)
        dv2, di2 = dense_pool(state["delta_emb"], q_vecs, state["delta_size"], k_delta)
        di2 = torch.where(di2 >= 0, di2 + state["delta_base_docs"], -1)
        dv2 = torch.where(di2 >= 0, dv2, 0.0)
        cat_v = torch.cat([dvals, dv2], dim=-1)
        cat_i = torch.cat([didx, di2], dim=-1)
        dvals, sel = stable_topk(cat_v, pool)
        didx = torch.gather(cat_i, -1, sel)

        bvals, bidx = bm25_ops.merge_delta_pool(
            bvals, bidx, state["delta_indptr"], state["delta_post_doc"], state["delta_post_w"],
            qterms["qtids_full"], pool, delta_cap, delta_max_df, state["delta_base_docs"])

    return fuse_pools_select(bvals, bidx, dvals, didx, k, router_module=router_module,
                             router_width=router_width)


def make_fused_sharded_query(
    mesh: Optional[DeviceMesh],
    shard_cap: int,
    router_module: Optional[RouterModule] = None,
    router_width: Optional[int] = None,  # router.trained_num_passages
    k: int = 10,
    pool: int = 50,
    beam: int = 128,
    approx_topk: bool = True,
    sparse_mode: str = "twotier",  # "twotier" | "scatter"
    lsel: int = 4096,
    nonneg: bool = True,
    delta_cap: int = 0,  # replicated live-ingest delta capacity (0 = none)
    delta_max_df: int = 0,
) -> Callable:
    """The sharded hybrid query (the multi-device hot path).

    The sharded twin of ``retrieval/fused.py::make_fused_hybrid_query``:
    each rank takes the dense and BM25 top-pools of its shard, one
    all-gather of the values and one of the ids bring every shard's pools to
    every rank, and the replicated tail (merge, delta, union merge, router or
    fixed fusion, final top-k) is the single-device ``fuse_pools_select``.

    Returns fn(state, q_vecs, qterms) -> (scores [B, k], global positions
    [B, k]). ``state`` combines ``shard_corpus_matrix``'s rows (``emb``),
    ``shard_bm25_twotier``'s tensors, the base ``size`` and, with a delta,
    ``delta_emb``, ``delta_indptr``, ``delta_post_doc``, ``delta_post_w``,
    ``delta_size`` and ``delta_base_docs``; ``qterms`` holds ``qtids``
    (clamped to the base vocabulary) and, with a delta, ``qtids_full``.
    """
    if sparse_mode not in ("twotier", "scatter"):
        raise ValueError(f"unknown sparse_mode {sparse_mode!r}")

    def shard_pools(state, q_vecs, qterms, shard):
        return fused_shard_pools(
            state, q_vecs, qterms, shard, shard_cap=shard_cap, pool=pool, beam=beam,
            approx_topk=approx_topk, sparse_mode=sparse_mode, lsel=lsel, nonneg=nonneg)

    def merge(vals, idx, state, q_vecs, qterms):
        return fused_merge(
            vals, idx, state, q_vecs, qterms, k=k, pool=pool, router_module=router_module,
            router_width=router_width, delta_cap=delta_cap, delta_max_df=delta_max_df)

    return _on_mesh(mesh, shard_pools, merge, n_merge_args=3)
