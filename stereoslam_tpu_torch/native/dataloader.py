"""ctypes binding for the C++ prefetching stereo loader (port of
``stereoslam_tpu/native/dataloader.py``; ``dataloader.cpp`` is a byte copy of
the JAX package's source).

The library is built with g++ and libpng at its first use, never at import,
into ``stereoslam_tpu_torch/_build/``, keyed by a hash of the source and the
flags as the LK kernel's build is, so an edited source is rebuilt.  No binary
is committed.  Where g++ or libpng is not installed, :func:`build_library`
raises :class:`ToolchainMissing`, and ``utils/kitti.py`` ``frames`` decodes
with a thread pool instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "dataloader.cpp"
_BUILD_DIR = _DIR.parent / "_build"
# stereoslam_tpu/native/Makefile's flags.
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
_LD_FLAGS = ("-shared", "-lpng", "-lpthread")


class ToolchainMissing(RuntimeError):
    """g++ or libpng is not installed, so the loader cannot be built."""


def build_library() -> Path:
    """Compile ``dataloader.cpp`` unless a build of this exact source and
    flags exists; returns the shared library's path."""
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_CXX_FLAGS + _LD_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"slamloader_{digest}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise ToolchainMissing("g++ is not on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp), *_LD_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        err = proc.stderr.strip()
        if "png.h" in err or "-lpng" in err:
            raise ToolchainMissing(f"libpng is not installed ({err.splitlines()[0]})")
        raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n{err}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first where needed (raises where it cannot
    be built or loaded)."""
    lib = ctypes.CDLL(str(build_library()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_probe_dims.restype = ctypes.c_int
    lib.loader_probe_dims.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def stream_pairs(
    left_paths: Sequence[str],
    right_paths: Sequence[str],
    timestamps: Sequence[float],
    prefetch: int = 4,
    n_threads: int = 2,
) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield decoded (left, right, timestamp) tuples with async prefetch."""
    lib = library()
    n = len(left_paths)
    if n == 0:
        return
    h0 = ctypes.c_int()
    w0 = ctypes.c_int()
    if lib.loader_probe_dims(left_paths[0].encode(), ctypes.byref(h0), ctypes.byref(w0)) != 0:
        raise IOError(f"cannot decode {left_paths[0]}")
    H, W = h0.value, w0.value

    larr = (ctypes.c_char_p * n)(*[p.encode() for p in left_paths])
    rarr = (ctypes.c_char_p * n)(*[p.encode() for p in right_paths])
    handle = lib.loader_create(larr, rarr, n, prefetch, n_threads)
    try:
        for _ in range(n):
            left = np.empty((H, W), np.uint8)
            right = np.empty((H, W), np.uint8)
            h = ctypes.c_int()
            w = ctypes.c_int()
            idx = lib.loader_next(
                handle,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.byref(h),
                ctypes.byref(w),
            )
            if idx == -1:
                return
            if idx == -2:
                continue  # decode error: skip frame
            yield left, right, float(timestamps[idx])
    finally:
        lib.loader_destroy(handle)
