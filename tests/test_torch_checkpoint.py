"""The port's flax checkpoint reader and writer against ``flax.serialization``.

``rag_uq_tpu_torch.utils.checkpoint`` decodes and encodes flax's msgpack
without the ``msgpack`` package. The reader is held to
``flax.serialization.msgpack_restore`` on the checkpoints in the repository
and on ``to_bytes`` trees of every leaf kind flax writes: same keys in the
same order, same shapes and dtypes, values bit for bit (bf16 compared as
its 16-bit patterns). The writer must give back the bytes of every
checkpoint in the repository from what the reader read, and the bytes of
``to_bytes`` on the same trees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rag_uq_tpu_torch.utils.checkpoint import (
    CheckpointFormatError,
    load_flax_checkpoint,
    read_msgpack,
    save_flax_checkpoint,
    write_msgpack,
)

CHECKPOINTS = [
    "models/encoder/encoder.msgpack",
    "models/tiny_lm/tiny_lm.msgpack",
    "models/tiny_lm_r5/tiny_lm.msgpack",
    "runs/demo_full_r4/encoder/encoder.msgpack",
    "runs/demo_full_r4/router/best_router.msgpack",
    "runs/demo_full_r4/router_reference3/best_router.msgpack",
]


def assert_same_tree(ours, ref, path="") -> int:
    """Returns the number of leaves compared."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict), path
        assert list(ours) == list(ref), path
        return sum(assert_same_tree(ours[k], ref[k], f"{path}/{k}") for k in ref)
    if isinstance(ref, (list, tuple)):
        assert list(map(type, ours)) == list(map(type, ref)) or len(ours) == len(ref), path
        return sum(assert_same_tree(o, r, f"{path}/{i}") for i, (o, r) in enumerate(zip(ours, ref)))
    if isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == np.shape(ref), path
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16), err_msg=path)
        return 1
    if isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref), (path, type(ours), type(ref))
        assert ours.dtype == ref.dtype and np.shape(ours) == np.shape(ref), path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
        return 1
    assert type(ours) is type(ref) and ours == ref, (path, ours, ref)
    return 1


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_reader_matches_flax_on_repo_checkpoints(path):
    with open(path, "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    assert assert_same_tree(load_flax_checkpoint(path), ref) > 0


def test_tiny_lm_keys_come_in_string_order():
    tree = load_flax_checkpoint("models/tiny_lm_r5/tiny_lm.msgpack")
    dense = [k for k in tree if k.startswith("Dense_")]
    assert dense[:3] == ["Dense_0", "Dense_1", "Dense_10"]  # consumers map by number


def _round_trip_trees():
    rng = np.random.default_rng(0)
    yield {
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), dtype=jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.5),
        "int32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "uint8": np.arange(7, dtype=np.uint8),
        "f64": rng.standard_normal(4),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "bool": np.array([True, False]),
        "empty_array": np.zeros((0, 3), dtype=np.float32),
        "scalars": {"f32": np.float32(-2.25), "i64": np.int64(-(2**40)), "zero_d": np.array(3.0)},
        "nested": ({"a": (1, 2.5, "x")}, [None, True, False]),
        "empty": {},
        "python": {"int": 7, "neg": -70000, "big": 2**63 - 1, "float": 0.1, "str": "héllo",
                   "long_str": "s" * 300, "bytes": b"\x00\x01"},
    }
    # Map, array and str lengths past the 16-bit sizes, and wide ints.
    yield {f"k{i}": np.int32(i) for i in range(70_000)}
    yield {"wide": [np.uint64(2**64 - 1), np.int8(-128), -(2**63)], "long": list(range(70_000))}


@pytest.mark.parametrize("case", [0, 1, 2])
def test_round_trip_of_to_bytes_trees(case):
    tree = next(t for i, t in enumerate(_round_trip_trees()) if i == case)
    data = serialization.to_bytes(tree)
    assert_same_tree(read_msgpack(data), serialization.msgpack_restore(data))


def test_chunked_leaves_are_reassembled(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "bf16": jnp.asarray(np.arange(70), dtype=jnp.bfloat16)}
    data = serialization.msgpack_serialize(tree)
    ours = read_msgpack(data)
    np.testing.assert_array_equal(ours["big"], tree["big"])
    np.testing.assert_array_equal(ours["bf16"].float().numpy(), np.arange(70, dtype=np.float32))


def test_corrupt_bytes_raise():
    data = serialization.to_bytes({"w": np.ones((4, 4), dtype=np.float32)})
    with pytest.raises(CheckpointFormatError):
        read_msgpack(data[:-5])
    with pytest.raises(CheckpointFormatError):
        read_msgpack(data + b"\x00")
    with pytest.raises(CheckpointFormatError):
        read_msgpack(b"\xc1")


def _torch_leaves(tree):
    """A flax state dict with its bf16 leaves as torch tensors, as the port
    holds them."""
    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)) and tree.dtype == jnp.bfloat16:
        bits = torch.from_numpy(np.array(np.asarray(tree).view(np.int16)))
        return bits.view(torch.bfloat16)
    return tree


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_writer_gives_back_repo_checkpoints(path, tmp_path):
    with open(path, "rb") as f:
        data = f.read()
    assert write_msgpack(load_flax_checkpoint(path)) == data
    save_flax_checkpoint(str(tmp_path / "sub" / "c.msgpack"), load_flax_checkpoint(path))
    assert (tmp_path / "sub" / "c.msgpack").read_bytes() == data


@pytest.mark.parametrize("case", [0, 1, 2])
def test_writer_matches_to_bytes(case):
    tree = next(t for i, t in enumerate(_round_trip_trees()) if i == case)
    state = serialization.msgpack_restore(serialization.to_bytes(tree))
    assert write_msgpack(_torch_leaves(state)) == serialization.to_bytes(tree)


def test_writer_refuses_what_flax_would_not_write():
    for bad in ({"l": [1, 2]}, {1: np.zeros(2)}, {"o": np.array([object()])},
                {"s": {1, 2}}):
        with pytest.raises(CheckpointFormatError):
            write_msgpack(bad)
