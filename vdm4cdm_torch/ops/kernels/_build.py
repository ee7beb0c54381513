"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``. The library lands in ``build/`` at
the repository root, named by a hash of its source, of every ``csrc/`` header
it includes (directly or through another header) and of the flags, so an
edited source or header rebuilds and an unchanged one loads at once. Nothing
runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_source_locks: dict = {}
_libs: dict = {}
build_log: dict = {}  # source name -> {"seconds": float, "ptxas": str}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_key(src: pathlib.Path, flags=NVCC_FLAGS) -> str:
    """The build key of ``src``: a hash of its bytes, of the bytes of every
    quoted include found beside it (followed through the headers it
    includes in turn) and of the flags."""
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b"\0" + data + b"\0")
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(data)]
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def c_function(source: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<source>`` (compiled if needed), taking
    ``argtypes`` and returning the launch's ``cudaGetLastError()`` as int."""
    fn = getattr(library(source), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, compiled if needed. One lock
    per source: threads that ask for different sources build side by side."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        if source in _libs:
            return _libs[source]
        src = CSRC / source
        out = BUILD_DIR / f"{src.stem}-{source_key(src)[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_out = pathlib.Path(tmp) / out.name
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out), str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp_out, out)
            build_log[source] = {"seconds": time.perf_counter() - t0,
                                 "ptxas": proc.stderr.strip()}
        lib = ctypes.CDLL(str(out))
        _libs[source] = lib
        return lib
