"""ctypes binding for the native (C++) data-loader core: counterpart of
``vdm4cdm_tpu/data/native.py``.

Builds the unchanged ``native/fastloader.cpp`` on first use (g++ -O3
-march=native) into ``build/native/`` at the repository root, under a name
this package owns and keyed by a hash of the source and flags, and exposes
``crop_batch`` (the fused periodic-crop + log-normalize + flip/permute batch
gather of CAMELSDataModule's fast path) and ``read_npy_direct``. The library
is written to a temporary name in that directory and moved into place with
``os.replace``, so no process ever opens a half-written library, and
``native/libfastloader.so`` (the JAX package's build) is never touched. When
no compiler is present the library is unavailable and the Python transform
path, also the correctness oracle, takes over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "fastloader.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-std=c++17",
             "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_F32P = ctypes.POINTER(ctypes.c_float)
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> pathlib.Path:
    """Where the library lands: named by a hash of the source's bytes and of
    the flags, so an edited source rebuilds."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"fastloader-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> bool:
    """Compile to a temporary name beside ``out``, then move it into place.
    False when there is no compiler or it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = pathlib.Path(tmp) / out.name
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp_out)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        except (subprocess.SubprocessError, FileNotFoundError):
            return False
        os.replace(tmp_out, out)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not SOURCE.exists():
            return None
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        lib = ctypes.CDLL(str(so))
        for name in ["fastloader_crop3d_batch", "fastloader_crop2d_batch"]:
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(_F32P), ctypes.c_int, ctypes.c_int64,  # stacks, nchan, full
                _i64p, _i64p, _i32p, _i32p,          # sim_idx, anchors, flips, perms
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_int64,      # batch, crop
                _F32P, _F32P, _F32P,                 # alphas, means, stds
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # normalize, channels_last, nthreads
            ]
        rd = lib.fastloader_read_direct
        rd.restype = ctypes.c_int
        rd.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,  # path, offset, nbytes
            ctypes.c_void_p, ctypes.c_int,                    # out, nthreads
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return load_library() is not None


def read_npy_direct(path: str, nthreads: int = 0) -> np.ndarray:
    """Cold-read a C-order .npy file into RAM via the native direct-IO path
    (O_DIRECT chunked parallel preads; buffered-pread fallback on filesystems
    without O_DIRECT). Bypasses the page-cache double buffering and the
    per-4K-page fault latency a cold np.memmap pays on its first epoch.
    Returns the full array; equivalent to np.load(path) for C-order inputs."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native fastloader unavailable")
    with open(path, "rb") as f:
        # public header readers dispatched on the magic version (the private
        # _read_array_header signature is not stable across numpy releases)
        version = np.lib.format.read_magic(f)
        if version >= (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        offset = f.tell()
    if fortran:
        raise ValueError(f"{path}: Fortran-order .npy unsupported by direct IO")
    out = np.empty(shape, dtype)
    rc = lib.fastloader_read_direct(
        path.encode(), offset, out.nbytes, out.ctypes.data_as(ctypes.c_void_p),
        int(nthreads))
    if rc != 0:
        raise IOError(f"fastloader_read_direct({path}) failed with rc={rc}")
    return out


def crop_batch(
    stacks: Sequence[np.ndarray],
    sim_idx: np.ndarray,
    anchors: np.ndarray,
    flips: np.ndarray,
    perms: np.ndarray,
    crop: int,
    alphas: Optional[Sequence[float]] = None,
    means: Optional[Sequence[float]] = None,
    stds: Optional[Sequence[float]] = None,
    channels_last: bool = True,
    nthreads: int = 0,
) -> np.ndarray:
    """Fused batch gather.

    stacks: per-channel arrays, each (nsims, full, ...) or (nsims, 1, full, ...)
    sim_idx (B,), anchors (B, nd), flips (B, nd) in {0,1}, perms (B, nd)
    (the permutation: output axis d reads cropped axis perms[d] — numpy
    transpose semantics). Returns float32 (B, *crop, C) or (B, C, *crop).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native fastloader unavailable")
    nd = int(anchors.shape[1])
    b = int(len(sim_idx))
    nchan = len(stacks)

    ptrs = (_F32P * nchan)()
    full = None
    keepalive = []
    for c, stack in enumerate(stacks):
        arr = np.asarray(stack)
        if arr.ndim == nd + 2:  # (nsims, 1, *spatial) — drop channel dim view
            if arr.shape[1] != 1:
                raise ValueError(f"stack {c}: {arr.shape[1]} channels, not 1")
            arr = arr.reshape(arr.shape[0], *arr.shape[2:])
        if arr.dtype != np.float32 or not arr.flags["C_CONTIGUOUS"]:
            raise ValueError(f"stack {c}: need C-contiguous float32, got "
                             f"{arr.dtype}")
        if full is None:
            full = arr.shape[-1]
        if arr.ndim != nd + 1 or any(s != full for s in arr.shape[1:]):
            raise ValueError(f"stack {c}: shape {arr.shape} is not "
                             f"(nsims, {full}, ...) in {nd}D")
        keepalive.append(arr)
        ptrs[c] = arr.ctypes.data_as(_F32P)

    out_shape = (b, *([crop] * nd), nchan) if channels_last else (b, nchan, *([crop] * nd))
    out = np.empty(out_shape, np.float32)

    normalize = alphas is not None
    if normalize:
        al = np.ascontiguousarray(alphas, np.float32)
        me = np.ascontiguousarray(means, np.float32)
        st = np.ascontiguousarray(stds, np.float32)
        alp, mep, stp = (a.ctypes.data_as(_F32P) for a in (al, me, st))
    else:
        alp = mep = stp = ctypes.cast(None, _F32P)

    fn = lib.fastloader_crop3d_batch if nd == 3 else lib.fastloader_crop2d_batch
    fn(
        ptrs, nchan, full,
        np.ascontiguousarray(sim_idx, np.int64),
        np.ascontiguousarray(anchors, np.int64),
        np.ascontiguousarray(flips, np.int32),
        np.ascontiguousarray(perms, np.int32),
        out.reshape(-1), b, crop,
        alp, mep, stp,
        int(normalize), int(channels_last), int(nthreads),
    )
    return out
