"""The msgpack subset a checkpoint payload uses, written out by hand.

The JAX package stores a checkpoint as ``msgpack.packb(payload,
use_bin_type=True)``, compressed. The port writes and reads the same bytes
without the ``msgpack`` package, which the card's machine does not have,
and without building the payload in memory: ``pack`` gives the bytes of
one small object, and a leaf's array goes out as a bin header followed by
its buffer, so the checkpoint streams into the compressor leaf by leaf.

Covered: nil, bool, int (the smallest encoding, as ``msgpack.packb``
picks it), float (as a double), str, bin (bytes, bytearray, memoryview),
arrays (lists and tuples) and maps (dicts, in their order). A bin holds at
most 4 GiB - 1 bytes, msgpack's own limit: one leaf of a checkpoint cannot
be larger.
"""
from __future__ import annotations

import struct

BIN_LIMIT = 2 ** 32 - 1


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix_base: int, fix_limit: int, codes: tuple) -> bytes:
    """The header of a str, array or map of ``n`` entries: the fix form
    below ``fix_limit``, else the 8- (str only), 16- or 32-bit form."""
    if n < fix_limit:
        return struct.pack("B", fix_base | n)
    for code, fmt, limit in codes:
        if n <= limit:
            return struct.pack(fmt, code, n)
    raise ValueError(f"{n} entries are more than msgpack holds")


def str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 32, ((0xD9, ">BB", 0xFF), (0xDA, ">BH", 0xFFFF),
                                (0xDB, ">BI", 0xFFFFFFFF)))


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, ((0xDC, ">BH", 0xFFFF),
                                (0xDD, ">BI", 0xFFFFFFFF)))


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, ((0xDE, ">BH", 0xFFFF),
                                (0xDF, ">BI", 0xFFFFFFFF)))


def bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return struct.pack("BB", 0xC4, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", 0xC5, n)
    if n <= BIN_LIMIT:
        return struct.pack(">BI", 0xC6, n)
    raise ValueError(f"a bin of {n} bytes is larger than msgpack's "
                     f"{BIN_LIMIT}: one checkpoint leaf holds at most 4 GiB")


def pack(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += [str_header(len(raw)), raw]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj)
        out += [bin_header(raw.nbytes), bytes(raw)]
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a "
                        f"checkpoint payload")


class Unpacker:
    """Reads msgpack objects from ``fill(memoryview)``, a function that
    fills the view with the stream's next bytes (raising ``EOFError`` at
    its end). ``obj()`` reads one whole object; a bin comes back as a
    ``bytearray``, which ``numpy.frombuffer`` wraps without a copy. Maps
    may be read entry by entry (``map_len`` then ``obj`` for each key and
    value), so a reader stops where it has what it needs."""

    def __init__(self, fill):
        self._fill = fill

    def _read(self, n: int) -> bytearray:
        buf = bytearray(n)
        if n:
            self._fill(memoryview(buf))
        return buf

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]

    def map_len(self) -> int:
        b = self._unpack("B")
        if b & 0xF0 == 0x80:
            return b & 0x0F
        if b == 0xDE:
            return self._unpack(">H")
        if b == 0xDF:
            return self._unpack(">I")
        raise ValueError(f"expected a msgpack map, got byte 0x{b:02x}")

    def obj(self):
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self._map(b & 0x0F)
        if b & 0xF0 == 0x90:
            return [self.obj() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return self._read(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:
            return self._read(self._unpack(lens[b]))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._read(self._unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one a "
                         f"checkpoint uses")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out
