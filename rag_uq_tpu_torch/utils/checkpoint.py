"""Read flax checkpoints (``flax.serialization.to_bytes``) without msgpack.

flax writes a state dict as msgpack: maps with string keys (tuples and
lists become maps keyed "0", "1", ...), with each array leaf an extension
of type 1 holding the msgpack triple ``(shape, dtype name, C-order bytes)``
and each numpy scalar an extension of type 3 in the same layout
(``flax/serialization.py``, ``_ndarray_to_bytes`` and ``_MsgpackExtType``).
This module decodes that subset: maps, arrays, str, bin, ints, floats,
nil, bool and those two extensions.

Array leaves come back as numpy arrays, except bfloat16 ones, which numpy
cannot hold without ``ml_dtypes``: those are ``torch.bfloat16`` tensors.
Leaves over 2**30 bytes, which flax splits into ``__msgpack_chunked_array__``
maps, are reassembled. Keys keep the file's order, which is sorted as
strings (``Dense_10`` before ``Dense_2``): consumers look layers up by name.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

Leaf = Union[np.ndarray, torch.Tensor]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class CheckpointFormatError(ValueError):
    """The bytes are not a flax msgpack checkpoint this reader understands."""


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointFormatError(f"truncated at byte {self.pos} (wanted {n} more)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise CheckpointFormatError(f"msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Leaf:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise CheckpointFormatError(f"msgpack extension type {code} is not an array")
        shape, dtype_name, raw = _Reader(payload).value()
        arr = _array(tuple(shape), dtype_name, raw)
        if code == _EXT_NPSCALAR:
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        return arr


def _array(shape: Tuple[int, ...], dtype_name: Union[str, bytes], raw: bytes) -> Leaf:
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        if len(raw) != 2 * int(np.prod(shape, dtype=np.int64)):
            raise CheckpointFormatError(f"bfloat16 leaf of shape {shape}: {len(raw)} bytes")
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if raw else \
            torch.empty((0,), dtype=torch.bfloat16)
        return flat.reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise CheckpointFormatError(f"unknown dtype {name!r}") from e
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked leaves (flattened pieces of one array)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(data: bytes) -> Any:
    """Decode one flax msgpack document into nested dicts of leaves."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise CheckpointFormatError(f"{len(reader.buf) - reader.pos} bytes after the document")
    return _unchunk(out)


def load_flax_checkpoint(path: str) -> Any:
    """Read a ``serialization.to_bytes`` file; raises if it cannot be read."""
    with open(path, "rb") as f:
        return read_msgpack(f.read())


def to_numpy_f32(leaf: Leaf) -> np.ndarray:
    """A leaf as a float32 numpy array (bfloat16 tensors widened exactly)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, dtype=np.float32)
