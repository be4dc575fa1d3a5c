"""Checkpoints: the JAX package's file format, written and read by the port.

A checkpoint is ``<dir>/ckpt_<step>.msgpack.zst``: the msgpack map
``{"step", "meta", "leaves": {path: {"dtype", "shape", "data"}}}``,
compressed. The leaves go in ``jax.tree.flatten``'s order and are keyed
by their tree path (``core.sparsify.flatten(with_paths=True)``), so the
JAX package's ``repro.checkpoint.restore`` reads what the port writes and
the port reads what it writes: the decompressed payloads of the same
state are byte-equal.

* **Writes** stream: the payload's exact length is known from the leaves'
  shapes and dtypes, and each leaf goes to the host, through the
  compressor and to disk before the next one is fetched, so host memory
  holds one leaf, not the state. The write is atomic (a tmp file, then
  ``os.replace``): a run killed mid-write leaves no truncated checkpoint
  for ``latest_step`` to find. ``keep=N`` prunes all but the N newest
  files after the new one is in place.
* **Compression**: zstd at level 3 (the JAX package's) when the
  ``zstandard`` module imports; otherwise zlib at level 0, stored blocks:
  about 7% larger than level 6 but written and read at the speed of a
  copy (level 6 runs at ~17 MB/s on a CPU core, minutes for the 4.6 GB of
  ResNet-50 + DGC at 1,020,250 classes). A reader tells the two apart by
  zstd's magic bytes and reads zlib at any level; reading a zstd file
  without ``zstandard`` raises.
* **Reads** stream too: ``read_meta`` decodes the payload up to ``meta``
  and stops, so a restore checks the geometry before any leaf is read.
* ``timings=`` (a dict) takes a save or a restore apart: ``save`` adds
  ``fetch_s``, the leaves' copies to the host (a card's included), and
  ``write_s``, the rest (encoding, compression, the file); ``restore``
  adds ``read_s``, reading and decoding the whole payload.

On a ring the trainer writes from member 0 after gathering the global
tree, and every member reads the whole file and keeps its own block.
"""
from __future__ import annotations

import os
import re
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.core.sparsify import flatten

try:
    import zstandard
except ImportError:          # the card's machine has no wheel: zlib instead
    zstandard = None

ZSTD_LEVEL = 3
ZLIB_LEVEL = 0
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_CHUNK = 1 << 26             # bytes handed to the compressor at a time
_READ_CHUNK = 1 << 22        # compressed bytes read from disk at a time
_FNAME = re.compile(r"ckpt_(\d+)\.msgpack\.zst$")


def codec_name() -> str:
    """The compression a ``save`` uses here: ``"zstd-3"`` or ``"zlib-0"``."""
    return (f"zstd-{ZSTD_LEVEL}" if zstandard is not None
            else f"zlib-{ZLIB_LEVEL}")


def _fname(path: str, step: int) -> str:
    return os.path.join(path, f"ckpt_{step}.msgpack.zst")


def _numpy_dtype(leaf) -> np.dtype:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bf16 tensor has no numpy dtype; checkpoint "
                            "leaves are fp32 master copies")
        return np.dtype(str(leaf.dtype).removeprefix("torch."))
    return np.asarray(leaf).dtype


def _host(leaf) -> np.ndarray:
    """The leaf as a C-contiguous host array (no copy for a CPU tensor)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu().contiguous().numpy()
    arr = np.asarray(leaf)      # (np.ascontiguousarray makes a 0-d one 1-d)
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


class _Leaf:
    """One leaf's record: its msgpack head (the path, dtype and shape, and
    the data's bin header), written before its data is fetched."""

    def __init__(self, key: str, leaf):
        self.leaf = leaf
        shape = [int(s) for s in np.shape(leaf)]
        dtype = _numpy_dtype(leaf)
        self.nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        self.head = (codec.pack(key) + codec.map_header(3)
                     + codec.pack("dtype") + codec.pack(str(dtype))
                     + codec.pack("shape") + codec.pack(shape)
                     + codec.pack("data") + codec.bin_header(self.nbytes))


def _head(step: int, meta: dict, n_leaves: int) -> bytes:
    """The payload's bytes up to its first leaf."""
    return (codec.map_header(3) + codec.pack("step") + codec.pack(step)
            + codec.pack("meta") + codec.pack(meta) + codec.pack("leaves")
            + codec.map_header(n_leaves))


def _payload_chunks(step: int, meta: dict, leaves: list,
                    timings: Optional[dict] = None):
    """The payload's bytes, in order: the head, then each leaf's record
    and its data, fetched to the host one leaf at a time (the fetches'
    seconds summed into ``timings["fetch_s"]``)."""
    timings = {"fetch_s": 0.0} if timings is None else timings
    yield _head(step, meta, len(leaves))
    for rec in leaves:
        yield rec.head
        if rec.nbytes:
            t0 = time.perf_counter()
            host = _host(rec.leaf)
            timings["fetch_s"] += time.perf_counter() - t0
            data = memoryview(host.reshape(-1).view(np.uint8))
            for lo in range(0, rec.nbytes, _CHUNK):
                yield data[lo:lo + _CHUNK]


def _payload_len(step: int, meta: dict, leaves: list) -> int:
    return len(_head(step, meta, len(leaves))) + sum(
        len(r.head) + r.nbytes for r in leaves)


def _write(fh, chunks, size: int) -> None:
    if zstandard is not None:
        cctx = zstandard.ZstdCompressor(level=ZSTD_LEVEL)
        # the content size in the frame header, which the JAX package's
        # one-shot ZstdDecompressor().decompress needs
        w = cctx.stream_writer(fh, size=size, closefd=False)
        for c in chunks:
            w.write(c)
        # the frame ends here; not in a ``with``, whose exit on an error
        # would end a short frame and raise over the error itself
        w.flush(zstandard.FLUSH_FRAME)
        return
    comp = zlib.compressobj(ZLIB_LEVEL)
    for c in chunks:
        fh.write(comp.compress(c))
    fh.write(comp.flush())


def save(path: str, tree: Any, step: int = 0, keep: Optional[int] = None,
         meta: Optional[dict] = None, timings: Optional[dict] = None) -> str:
    """Write ``<path>/ckpt_<step>.msgpack.zst`` from ``tree`` (dicts,
    lists, tuples, NamedTuples; leaves tensors on any device, numpy arrays
    or numbers). Returns the file's path. ``meta`` is a small dict stored
    beside the leaves (the trainer's mesh geometry); ``timings`` gains
    ``fetch_s`` and ``write_s``."""
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    leaves = [_Leaf(k, v) for k, v in flatten(tree, with_paths=True)[0]]
    meta = dict(meta or {})
    fname = _fname(path, step)
    tmp = fname + f".tmp.{os.getpid()}"
    parts = {"fetch_s": 0.0}
    try:
        with open(tmp, "wb") as fh:
            _write(fh, _payload_chunks(step, meta, leaves, parts),
                   _payload_len(step, meta, leaves))
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if keep:
        prune(path, keep)
    if timings is not None:
        timings["fetch_s"] = parts["fetch_s"]
        timings["write_s"] = time.perf_counter() - t0 - parts["fetch_s"]
    return fname


def all_steps(path: str) -> list:
    """Sorted step numbers of every checkpoint under ``path``."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for fn in os.listdir(path)
                  if (m := _FNAME.match(fn)))


def prune(path: str, keep: int) -> list:
    """Delete all but the ``keep`` highest-step checkpoint files. Returns
    the pruned step numbers (ascending: the oldest go first)."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    doomed = all_steps(path)[:-keep]
    for s in doomed:
        os.remove(_fname(path, s))
    return doomed


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


class _ZlibStream:
    """``readinto`` over a zlib stream in a file, a bounded piece at a
    time."""

    def __init__(self, fh):
        self._fh, self._d, self._tail = fh, zlib.decompressobj(), b""

    def readinto(self, view) -> int:
        while not self._d.eof:
            if not self._tail:
                self._tail = self._fh.read(_READ_CHUNK)
                if not self._tail:
                    return 0
            out = self._d.decompress(self._tail, view.nbytes)
            self._tail = self._d.unconsumed_tail
            if out:
                view[:len(out)] = out
                return len(out)
        return 0


def _unpacker(fh) -> codec.Unpacker:
    """A msgpack reader over the decompressed payload of an open file."""
    magic = fh.read(4)
    fh.seek(0)
    if magic == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "'zstandard' module is unavailable")
        stream = zstandard.ZstdDecompressor().stream_reader(fh)
    else:
        stream = _ZlibStream(fh)

    def fill(view):
        while view.nbytes:
            n = stream.readinto(view)
            if not n:
                raise EOFError(f"checkpoint {fh.name} ends mid-payload")
            view = view[n:]
    return codec.Unpacker(fill)


def _resolve(path: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return _fname(path, step)


def _read_payload(path: str, step: Optional[int], *, until: str = ""):
    """The payload's entries in file order, as a dict; with ``until``,
    stop before decoding that key (``read_meta``: before the leaves)."""
    with open(_resolve(path, step), "rb") as fh:
        up = _unpacker(fh)
        out = {}
        for _ in range(up.map_len()):
            key = up.obj()
            if key == until:
                break
            out[key] = up.obj()
        return out


def read_meta(path: str, step: Optional[int] = None) -> Optional[dict]:
    """The meta dict stored with a checkpoint (``save(meta=...)``), read
    without decoding a leaf; None for files written before meta existed."""
    return _read_payload(path, step, until="leaves").get("meta") or None


def validate_restore(path: str, expect, step: Optional[int] = None, *,
                     reshard: bool = False):
    """The geometry check before any leaf is decoded: ``expect`` is the
    restoring trainer's ``elastic.MeshGeometry``. Raises
    ``elastic.ReshardError`` naming both geometries when the class count
    differs, or the ring differs without ``reshard``. Returns the
    checkpoint's geometry (``expect`` for a file without meta)."""
    from repro_torch.elastic.plan import geometry_from_meta, validate_geometry
    src = geometry_from_meta(read_meta(path, step), expect)
    validate_geometry(src, expect, reshard=reshard)
    return src


def restore(path: str, target: Any, step: Optional[int] = None, *,
            timings: Optional[dict] = None):
    """``target``'s structure refilled with the checkpoint's leaves, as
    host numpy arrays (of the stored shapes, which may differ from the
    target's: only its tree paths are read). Returns (tree, step);
    ``timings`` gains ``read_s``."""
    t0 = time.perf_counter()
    payload = _read_payload(path, step)
    stored = payload["leaves"]
    pairs, unflatten = flatten(target, with_paths=True)
    new = []
    for key, _ in pairs:
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = stored.pop(key)
        new.append(np.frombuffer(rec["data"], dtype=rec["dtype"])
                   .reshape(rec["shape"]))
    if timings is not None:
        timings["read_s"] = time.perf_counter() - t0
    return unflatten(new), payload["step"]
