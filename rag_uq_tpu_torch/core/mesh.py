"""Process groups, corpus meshes and placements: the counterpart of
``rag_uq_tpu/core/mesh.py``.

The JAX package is single-controller: one process drives every chip of a
``jax.sharding.Mesh``. The port is SPMD in PyTorch's idiom: one process (a
rank) per shard, every rank running the same program in one
``torch.distributed`` process group. A mesh is a one-dimensional
``DeviceMesh`` over the group's first ranks, its dimension named
``CORPUS_AXIS``; a rank's shard index is its coordinate on it.

The collective backend is NCCL for ranks on cards and gloo for CPU ranks.
NCCL refuses two ranks on one card, so ranks that share a card join a gloo
group, whose collectives take CUDA tensors through host memory; NCCL on a
machine with one card can be checked with one rank only.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
from torch.distributed.device_mesh import DeviceMesh

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device

CORPUS_AXIS = "corpus"
DATA_AXIS = "data"


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(num_corpus_shards: Optional[int] = None, device: DeviceLike = "cuda") -> DeviceMesh:
    """A 1-D corpus mesh over the first ``num_corpus_shards`` ranks (all by
    default) of the default process group.

    Without a group, starts a one-rank group on a ``HashStore`` (NCCL for a
    card, gloo for the CPU). Every rank of the group must call this, also
    ranks the mesh leaves out (their coordinate is None).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    n = num_corpus_shards or world
    if n > world:
        raise ValueError(f"Requested {n} shards but only {world} ranks")
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(CORPUS_AXIS,))


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join this process to the default process group (the multi-node seam).

    Each rank calls this before it builds a mesh. With no arguments it reads
    what ``torchrun`` sets: ``MASTER_ADDR``/``MASTER_PORT`` (the ``env://``
    rendezvous), ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, which also
    picks the rank's card. Returns False, and does nothing, when neither an
    address nor a world size is configured (one process: ``make_mesh``
    starts a one-rank group), True once the group exists.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size is None:
        return False
    if rank is None:
        rank = int(env.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend or _default_backend(dev), init_method=init_method,
                            world_size=world_size or 1, rank=rank)
    return True


def make_multihost_mesh(shards_per_host: Optional[int] = None,
                        device: DeviceLike = "cuda") -> DeviceMesh:
    """Corpus mesh over every node's ranks, host-major.

    ``torchrun`` numbers ranks node by node (``LOCAL_WORLD_SIZE`` a node),
    so consecutive shard ranges live on one node's cards and the pool
    all-gather does most of its work over NVLink before it crosses nodes.
    Takes the first ``shards_per_host`` ranks of each node (all by default);
    falls back to ``make_mesh`` on one node.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_nodes = world // max(per_node, 1)
    if n_nodes <= 1:
        return make_mesh(shards_per_host, device)
    per_host = shards_per_host or per_node
    if per_host > per_node:
        raise ValueError(f"Requested {per_host} shards a node but a node has {per_node} ranks")
    ranks = [h * per_node + j for h in range(n_nodes) for j in range(per_host)]
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=(CORPUS_AXIS,))


def corpus_sharding(mesh: DeviceMesh) -> list:
    """Rows split over the corpus dimension: the placement of ``P(CORPUS_AXIS)``."""
    from torch.distributed.tensor import Shard  # imported at use: a slow import

    del mesh
    return [Shard(0)]


def replicated(mesh: DeviceMesh) -> list:
    """Every rank holds all of it: the placement of ``P()``."""
    from torch.distributed.tensor import Replicate

    del mesh
    return [Replicate()]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's shard index on the corpus mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return coord[0]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank keeps its shard on: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_shards(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` stacked in mesh order: ``[S, *x.shape]`` on all ranks.

    A list all-gather, which gloo takes for CPU and CUDA tensors and NCCL
    for CUDA tensors (gloo's ``all_gather_into_tensor`` refuses an output
    with a leading shard dimension).
    """
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.stack(parts)


def _rank_main(rank: int, world_size: int, init_method: str, backend: str,
               fn: Callable, args_path: str) -> None:
    with open(args_path, "rb") as f:
        args = pickle.load(f)  # written by _spawn_ranks in this launch
    torch.set_num_threads(1)  # N ranks on a shared host: one thread each
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), backend: str = "gloo",
                 timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined in one group (a file rendezvous in a new temporary directory, so
    concurrent launches never meet), and wait for all of them.

    ``fn`` must be importable by its module path (the children import it),
    and that module should import no JAX. Raises if a rank fails; kills
    every rank and raises ``TimeoutError`` after ``timeout_s`` seconds.
    """
    with tempfile.TemporaryDirectory(prefix="rag_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        # The arguments go through a file: a start blocks until the child
        # has read what it is sent, so large arguments sent directly would
        # start the ranks one after another.
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        ctx = torch_mp.start_processes(
            _rank_main, args=(world_size, init, backend, fn, args_path),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        procs: List = list(ctx.processes)
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
