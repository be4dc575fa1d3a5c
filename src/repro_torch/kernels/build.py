"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds each into its own shared library in seconds; the libraries
are loaded with ``ctypes``. Code that two kernels share lives in a
``csrc/*.cuh`` header that each includes. The build runs at first use, one ``nvcc`` per
source, all started together, into ``build/repro_torch_kernels/`` at the
root of the checkout. A library's file name carries a hash of its source,
the headers and the flags, so an edited source is rebuilt and an unchanged
one is reused.
``nvcc``'s register and shared-memory report (``-Xptxas -v``) is kept
beside each library as ``<name>-<hash>.log``.

Pointers and the stream cross into C as ``c_void_p``; each C entry point
returns ``cudaGetLastError()`` after its launches, which ``check`` turns
into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``) from PATH or
    CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        f"{name} not found (looked on PATH and under CUDA_HOME or "
        f"/usr/local/cuda): the CUDA kernels are built on the machine with "
        f"the card")


def _nvcc() -> str:
    return cuda_tool("nvcc")


def _target(src: Path) -> Path:
    # the shared headers are hashed with every source that may include them
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns {source stem: library path}."""
    srcs = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not targets[s.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for s in todo:
            out = targets[s.stem]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(".log").open("w")
            jobs.append((s, out, tmp, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for s, out, tmp, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
            else:
                failed.append(f"{s.name} (rc={rc}): "
                              f"{out.with_suffix('.log').read_text()}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of every built library."""
    return "\n".join(p.with_suffix(".log").read_text()
                     for p in build_all().values()
                     if p.with_suffix(".log").exists())


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        _loaded[stem] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
