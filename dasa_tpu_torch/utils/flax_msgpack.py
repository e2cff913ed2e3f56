"""Read the JAX package's checkpoint files with numpy and torch alone.

The JAX package writes flax's msgpack encoding (``flax.serialization``:
``msgpack_serialize`` / ``to_bytes``), either as a whole file (the
listener's ``save``) or as bytes inside a pickle of plain dicts (the
speaker's ``save``, the Pretrainer's ``save``, the listener's round-1
format).  This module reads both without ``flax``, ``msgpack`` or JAX:

- :func:`msgpack_restore` is the counterpart of
  ``flax.serialization.msgpack_restore``: maps, arrays, str, bin, int,
  float, nil and bool; flax's ext types 1 (ndarray: the packed tuple
  ``(shape, dtype name, C-order bytes)``), 2 (complex) and 3 (numpy
  scalar), any other ext type being an error; and the chunked form of arrays over 2**30 bytes
  (``__msgpack_chunked_array__``).  ``bfloat16``, which numpy cannot
  name, becomes a ``torch.bfloat16`` tensor; every other array a numpy
  array.
- :func:`file_format` tells the formats apart by their first bytes: a
  torch file (zip archive or the legacy pickle with torch's magic
  number), a plain pickle, or a msgpack map.
- :func:`load_plain_pickle` unpickles dicts, ints and bytes and refuses
  any class or persistent id, so it runs no code from the file.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any

import numpy as np
import torch

ZIP_MAGIC = b"PK\x03\x04"
# torch.save(..., _use_new_zipfile_serialization=False) begins with a
# protocol-2 pickle of torch's magic number 0x1950a86a20f9469cfc6c
TORCH_LEGACY_MAGIC = b"\x80\x02\x8a\x0al\xfc\x9cF\xf9 j\xa8P\x19"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (big-endian, as the spec)."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.views = views  # bin as views into the buffer, not copies

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
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
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
                 0xC9: (">I", self.ext)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: invalid type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int):
        out = self.take(n)
        return out if self.views else bytes(out)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[bytes(key) if isinstance(key, memoryview) else key] = \
                self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from_bytes(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _unpack_all(data)
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not flax's")


def _unpack_all(data, views: bool = False) -> Any:
    reader = _Reader(data, views)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the end of the object")
    return out


def _ndarray_from_bytes(data):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
    shape, name, buf = _unpack_all(data, views=True)
    if not isinstance(name, str):
        name = bytes(name).decode()
    if name == "bfloat16":
        flat = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: array dtype {name!r} not readable") from e
    return np.frombuffer(buf, dtype).reshape(shape).copy()


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked arrays back into
    array leaves."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts / lists of python
    values and arrays, as ``flax.serialization.msgpack_restore`` does."""
    return _unchunk(_unpack_all(data))


def file_format(path: str) -> str:
    """``"torch"`` (a zip archive or torch's legacy pickle), ``"pickle"``
    (a plain pickle, protocol 2-5) or ``"msgpack"`` (a msgpack map), from
    the file's first bytes; any other file raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(len(TORCH_LEGACY_MAGIC))
    if head.startswith(ZIP_MAGIC) or head.startswith(TORCH_LEGACY_MAGIC):
        return "torch"
    if len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "pickle"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise ValueError(f"{path!r} is neither a torch file, a pickle nor a "
                     "msgpack map")


class _PlainUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"refusing {module}.{name}: a JAX checkpoint pickle holds only "
            "dicts, ints and bytes")


def load_plain_pickle(path: str) -> Any:
    """Unpickle ``path`` with every class and persistent id refused."""
    with open(path, "rb") as f:
        return _PlainUnpickler(io.BytesIO(f.read())).load()
