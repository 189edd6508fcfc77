"""Read and write flax checkpoints (``flax.serialization.to_bytes``)
without msgpack.

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

``write_msgpack`` is the inverse: nested dicts with string keys, numpy
arrays (extension 1), numpy scalars (extension 3), bfloat16 torch tensors
(extension 1 with the dtype name "bfloat16"), Python ints, floats, strings,
bytes, bools and None, packed as msgpack-python packs them (the smallest integer
and length forms, floats as doubles), so a tree flax would write comes out
byte for byte as ``flax.serialization.to_bytes`` writes it. Leaves over
2**30 bytes, which flax would chunk, are refused.
"""

from __future__ import annotations

import struct
from pathlib import Path
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


_MAX_LEAF_BYTES = 1 << 30


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def head(self, fix: int, fix_max: int, forms, n: int) -> None:
        """A length or integer head: ``fix | n`` while n < fix_max, else
        the first of ``forms`` ((type byte, struct format, max)) that holds n."""
        if n < fix_max:
            self.out.append(fix | n)
            return
        for byte, fmt, top in forms:
            if n <= top:
                self.out.append(byte)
                self.out += struct.pack(fmt, n)
                return
        raise CheckpointFormatError(f"length {n} is too large for msgpack")

    def int(self, n: int) -> None:
        if 0 <= n < 0x80:
            self.out.append(n)
        elif -32 <= n < 0:
            self.out.append(n & 0xFF)
        elif n > 0:
            self.head(0, 0, ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                             (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", (1 << 64) - 1)), n)
        else:
            for byte, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                   (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if n >= low:
                    self.out.append(byte)
                    self.out += struct.pack(fmt, n)
                    return
            raise CheckpointFormatError(f"integer {n} is too small for msgpack")

    def str(self, s: str) -> None:
        raw = s.encode("utf-8")
        self.head(0xA0, 32, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                             (0xDB, ">I", 0xFFFFFFFF)), len(raw))
        self.out += raw

    def bin(self, raw: bytes) -> None:
        self.head(0, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                         (0xC6, ">I", 0xFFFFFFFF)), len(raw))
        self.out += raw

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out.append(fixed[n])
        else:
            self.head(0, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                             (0xC9, ">I", 0xFFFFFFFF)), n)
        self.out += struct.pack(">b", code)
        self.out += payload

    def value(self, x: Any) -> None:
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, dict):
            self.head(0x80, 16, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)), len(x))
            for key, v in x.items():
                if not isinstance(key, str):
                    raise CheckpointFormatError(f"map key {key!r} is not a string")
                self.str(key)
                self.value(v)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            self.ext(_EXT_NDARRAY, _array_payload(x))
        elif isinstance(x, np.generic):
            self.ext(_EXT_NPSCALAR, _array_payload(np.asarray(x)))
        elif isinstance(x, int):
            self.int(x)
        elif isinstance(x, float):
            self.out.append(0xCB)
            self.out += struct.pack(">d", x)
        elif isinstance(x, str):
            self.str(x)
        elif isinstance(x, bytes):
            self.bin(x)
        else:
            raise CheckpointFormatError(f"cannot write a {type(x).__name__} leaf")


def _array_payload(arr: Leaf) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
    if isinstance(arr, np.ndarray):
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise CheckpointFormatError(f"cannot write dtype {arr.dtype}")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    if len(raw) > _MAX_LEAF_BYTES:
        raise CheckpointFormatError(f"a leaf of {len(raw)} bytes would be chunked by flax")
    w = _Writer()
    w.head(0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)), 3)
    w.head(0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)), len(shape))
    for n in shape:
        w.int(int(n))
    w.str(name)
    w.bin(raw)
    return bytes(w.out)


def write_msgpack(tree: Any) -> bytes:
    """Encode nested dicts of leaves as flax's ``msgpack_serialize`` does."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def save_flax_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` (its directory made), readable by
    ``flax.serialization.from_bytes`` and by ``load_flax_checkpoint``."""
    data = write_msgpack(tree)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
