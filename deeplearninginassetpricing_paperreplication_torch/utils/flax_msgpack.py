"""A reader for flax ``.msgpack`` checkpoints, on the stdlib and NumPy only.

The JAX package saves its parameter trees with flax's
``serialization.to_bytes``: a msgpack map of str keys whose leaves are
msgpack extension values (code 1, an ndarray packed as the msgpack array
``(shape, dtype name, C-order bytes)``; code 3, a NumPy scalar packed the
same way; code 2, a native complex as ``(real, imag)``), and arrays above
flax's ``MAX_CHUNK_SIZE`` split into ``__msgpack_chunked_array__`` maps of
flat chunks. :func:`loads` decodes those bytes to the tree
``flax.serialization.msgpack_restore`` gives: nested dicts of NumPy arrays,
leaf for leaf the same bits. A bfloat16 leaf (NumPy has no such dtype)
widens exactly to float32.

The port imports neither msgpack nor flax (a machine with the card need
not have them), so this is how a JAX run directory loads in the port.
Bytes that are truncated, carry an unknown type byte or a malformed
extension raise ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# msgpack's type bytes past the fix ranges: constants; (length format,
# reader) of str, bin, array and map; numbers; ext with a fixed or a read
# length
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    """One pass over a msgpack byte string; `raw` keeps str as bytes (the
    ndarray extension's inner encoding)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
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
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SIZED:
            fmt, read = _SIZED[b]
            return getattr(self, read)(self.unpack(fmt))
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"malformed msgpack: type byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int):
        data = bytes(self.take(n))
        if self.raw:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"malformed msgpack str: {e}") from None

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, (dict, list)):
                raise ValueError("malformed msgpack: unhashable map key")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            parts = _whole(data, raw=False)
            if not (isinstance(parts, list) and len(parts) == 2):
                raise ValueError("malformed msgpack complex extension")
            return complex(parts[0], parts[1])
        raise ValueError(f"unknown msgpack extension type {code}")


def _whole(data: bytes, raw: bool) -> Any:
    """Decode one value that must span `data` exactly."""
    r = _Reader(data, raw)
    value = r.value()
    if r.pos != len(data):
        raise ValueError(f"malformed msgpack: {len(data) - r.pos} trailing "
                         "bytes")
    return value


def _dtype(name: bytes) -> Tuple[np.dtype, bool]:
    """(the dtype the bytes hold, whether they are bfloat16)."""
    if name == b"bfloat16":
        return np.dtype(np.uint16), True
    try:
        return np.dtype(name.decode("ascii")), False
    except (TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"malformed ndarray dtype {name!r}: {e}") from None


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray extension: msgpack ``(shape, dtype name, bytes)``."""
    tpl = _whole(data, raw=True)
    if not (isinstance(tpl, list) and len(tpl) == 3
            and isinstance(tpl[0], list) and isinstance(tpl[1], bytes)
            and isinstance(tpl[2], bytes)
            and all(isinstance(s, int) and s >= 0 for s in tpl[0])):
        raise ValueError("malformed msgpack ndarray extension")
    shape, name, buf = tpl
    dtype, bf16 = _dtype(name)
    if len(buf) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"ndarray of shape {shape} {name.decode()} holds "
                         f"{len(buf)} bytes")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    if bf16:  # the high half of a float32: widen exactly
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps → arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        try:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed chunked array: {e}") from None
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives."""
    return _unchunk(_whole(bytes(data), raw=False))
