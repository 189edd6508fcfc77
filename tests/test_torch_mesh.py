"""The port's process groups and meshes (``rag_uq_tpu_torch/core/mesh.py``)
and data-parallel encoding (``embed/base.py::encode_on_mesh``), against the
JAX package's ``core/mesh.py`` where the two can be compared.

In this process: ``make_mesh`` without a group starts a one-rank gloo group
(each test that makes one destroys it after), its error for more shards
than ranks is JAX's, ``initialize_distributed`` returns False with no
rendezvous configured (``tests/test_sharding.py:139-158``), and
``pad_to_multiple`` is JAX's. In four spawned gloo ranks (one launch for
the module, ``tests/test_torch_spawn.py::mesh_program``): the mesh on the
group, a two-rank sub-mesh, and ``encode_mesh`` of both embedders on an
uneven batch against ``encode`` on one rank, which JAX holds within 1e-5
(hash embedder) and 2e-2 (transformer) (``tests/test_sharding.py:207-228``);
the port holds both within 1e-6, since each row is computed alone.
"""

import os
import tempfile

import numpy as np
import pytest
import torch.distributed as dist

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.core import mesh as jax_mesh  # noqa: E402
from rag_uq_tpu_torch.core import mesh as port_mesh  # noqa: E402

from tests.test_torch_spawn import mesh_program  # noqa: E402

WORLD = 4


@pytest.fixture
def no_group():
    """No default group before the test, and none left after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    port_mesh._spawn_ranks(mesh_program, WORLD, (str(out),))
    return [dict(np.load(out / f"mesh_{r}.npz")) for r in range(WORLD)]


def test_axis_names_match_jax():
    assert port_mesh.CORPUS_AXIS == jax_mesh.CORPUS_AXIS
    assert port_mesh.DATA_AXIS == jax_mesh.DATA_AXIS


def test_make_mesh_without_a_group_starts_one_rank(no_group):
    mesh = port_mesh.make_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("corpus",)
    assert port_mesh.mesh_rank(mesh) == 0 and dist.get_backend() == "gloo"
    assert str(port_mesh.mesh_device(mesh)) == "cpu"
    with pytest.raises(ValueError, match="Requested 2 shards but only 1"):
        port_mesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="Requested 2 shards but only 1"):
        jax_mesh.make_mesh(2, devices=jax_mesh.jax.devices()[:1])


def test_multihost_mesh_falls_back_to_one_node(no_group):
    mesh = port_mesh.make_multihost_mesh(device="cpu")
    assert mesh.size() == dist.get_world_size() == 1


def test_initialize_distributed_is_a_noop_without_a_rendezvous(no_group, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert port_mesh.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert port_mesh.corpus_sharding(None) == [Shard(0)]
    assert port_mesh.replicated(None) == [Replicate()]


@pytest.mark.parametrize("n,m", [(100, 128), (128, 128), (129, 128), (0, 8), (7, 3)])
def test_pad_to_multiple_matches_jax(n, m):
    assert port_mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_on_a_group(ranks, rank):
    got = ranks[rank]
    assert int(got["size"]) == WORLD and int(got["rank"]) == rank
    assert str(got["too_many"]) == f"Requested {WORLD + 1} shards but only {WORLD} ranks"
    assert int(got["sub_coord"]) == (rank if rank < 2 else -1)


@pytest.mark.parametrize("rank", range(WORLD))
def test_encode_mesh_equals_encode(ranks, rank):
    got = ranks[rank]
    assert got["hash_mesh"].shape == (11, 64) and got["enc_mesh"].shape == (9, 32)
    np.testing.assert_allclose(got["hash_mesh"], got["hash_one"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["hash_sub"], got["hash_one"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["enc_mesh"], got["enc_one"], atol=1e-6, rtol=0)
    assert got["empty"].shape == (0, 64)
    # Every rank holds the same whole batch.
    np.testing.assert_array_equal(got["hash_mesh"], ranks[0]["hash_mesh"])
    np.testing.assert_array_equal(got["enc_mesh"], ranks[0]["enc_mesh"])
