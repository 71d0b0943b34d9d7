"""The SVD of small float32 and float64 matrices on the card without a host
read.

``torch.linalg.svd`` on a CUDA tensor runs cuSOLVER's batched Jacobi SVD
(``gesvdjBatched``) for matrices of at most 32x32, then reads the
convergence flags back on the host (to re-solve a matrix that did not
converge with ``gesvd``), so it cannot be captured in a CUDA graph.
:func:`svd` calls the same cuSOLVER routine (``Sgesvdj`` for float32,
``Dgesvdj`` for float64) with the same parameters (tolerance: the dtype's
machine epsilon; cuSOLVER's default sweeps and ordering) and reads nothing
back.  Those parameters were found by comparing the two on the card;
``chip_smoke.py`` (``check_svd``) holds U, S and Vh to ``torch.linalg.svd``
bit for bit on 3x3 rotations off by 1e-7 to 1 of noise, in both dtypes, one
call at a time and batched (float64 also as the windowed BA's batch of 7).
A 3x3 Jacobi SVD converges in a few sweeps, so the re-solve that is left
out does not arise for the rotation blocks this serves: the tracked frame's
float32 pose and the windowed BA's float64 window poses.

On CPU tensors, other dtypes and larger matrices :func:`svd` is
``torch.linalg.svd`` itself.  The cuSOLVER call is the custom op
``stereoslam::svd_small``, whose batching rule hands ``torch.func.vmap``'s
dimension to the routine's own batch (the batched multi-sequence mode
vmaps the tracked step over its sequences).  cuSOLVER is the library PyTorch loaded; it is
bound with ctypes at the first CUDA call, never at import.  That first call
of each dtype must not be inside a capture (a warm-up call makes it): it
creates the cuSOLVER handle and the dtype's parameters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch import Tensor

_MAX_SIDE = 32          # gesvdjBatched's limit on m and n
_EIG_MODE_VECTOR = 1    # CUSOLVER_EIG_MODE_VECTOR: U and V too
_PREFIX = {torch.float32: "S", torch.float64: "D"}  # cuSOLVER's routine per dtype


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The cuSOLVER library that PyTorch loaded."""
    # A solver call that reads nothing back makes PyTorch load cuSOLVER.
    torch.linalg.cholesky_ex(torch.ones((1, 1), device="cuda"))
    with open("/proc/self/maps") as maps:
        paths = sorted({line.split()[-1] for line in maps if "/libcusolver.so" in line})
    if not paths:
        raise RuntimeError("cuSOLVER is not loaded in this process: torch.linalg did not load it")
    lib = ctypes.CDLL(paths[0])
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.cusolverDnCreate.argtypes = [p]
    lib.cusolverDnSetStream.argtypes = [p, p]
    lib.cusolverDnCreateGesvdjInfo.argtypes = [p]
    lib.cusolverDnXgesvdjSetTolerance.argtypes = [p, d]
    fns = [lib.cusolverDnCreate, lib.cusolverDnSetStream, lib.cusolverDnCreateGesvdjInfo,
           lib.cusolverDnXgesvdjSetTolerance]
    for x in _PREFIX.values():
        size = getattr(lib, f"cusolverDn{x}gesvdjBatched_bufferSize")
        run = getattr(lib, f"cusolverDn{x}gesvdjBatched")
        size.argtypes = [p, i, i, i, p, i, p, p, i, p, i, p, p, i]
        run.argtypes = [p, i, i, i, p, i, p, p, i, p, i, p, i, p, p, i]
        fns += [size, run]
    for fn in fns:
        fn.restype = i  # cusolverStatus_t
    return lib


@functools.lru_cache(maxsize=None)
def _params(dtype: torch.dtype) -> ctypes.c_void_p:
    """The gesvdj parameters for ``dtype``: tolerance its machine epsilon."""
    lib = _library()
    params = ctypes.c_void_p()
    _check(lib.cusolverDnCreateGesvdjInfo(ctypes.byref(params)), "cusolverDnCreateGesvdjInfo")
    _check(lib.cusolverDnXgesvdjSetTolerance(params, float(torch.finfo(dtype).eps)),
           "cusolverDnXgesvdjSetTolerance")
    return params


@functools.lru_cache(maxsize=None)
def _handle(device_index: int) -> ctypes.c_void_p:
    lib = _library()
    handle = ctypes.c_void_p()
    with torch.cuda.device(device_index):
        _check(lib.cusolverDnCreate(ctypes.byref(handle)), "cusolverDnCreate")
    return handle


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} failed with cuSOLVER status {status}")


def svd(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``torch.linalg.svd(A)`` for (..., m, n): (U, S, Vh).  On a float32 or
    float64 CUDA tensor with m, n <= 32, cuSOLVER's batched Jacobi SVD,
    launched on the current stream with no host read."""
    m, n = A.shape[-2:]
    if A.device.type != "cuda" or A.dtype not in _PREFIX or max(m, n) > _MAX_SIDE:
        return torch.linalg.svd(A)
    return _svd_op(A)


@torch.library.custom_op("stereoslam::svd_small", mutates_args=())
def _svd_op(A: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _gesvdj_batched(A)


@_svd_op.register_vmap
def _svd_vmap(info, in_dims, A):
    return _gesvdj_batched(A.movedim(in_dims[0], 0)), (0, 0, 0)


def _gesvdj_batched(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cuSOLVER's ``gesvdjBatched`` over the leading dims of a float32 or
    float64 CUDA (..., m, n), on the current stream."""
    m, n = A.shape[-2:]
    lib, params, x = _library(), _params(A.dtype), _PREFIX[A.dtype]
    batch = A.shape[:-2]
    a = A.reshape(-1, m, n).transpose(-1, -2).contiguous()  # column-major, as cuSOLVER reads it
    b, dev = a.shape[0], A.device
    S = torch.empty((b, min(m, n)), dtype=A.dtype, device=dev)
    U = torch.empty((b, m, m), dtype=A.dtype, device=dev)
    V = torch.empty((b, n, n), dtype=A.dtype, device=dev)
    info = torch.empty((b,), dtype=torch.int32, device=dev)
    handle = _handle(dev.index if dev.index is not None else torch.cuda.current_device())
    lwork = ctypes.c_int()
    _check(getattr(lib, f"cusolverDn{x}gesvdjBatched_bufferSize")(
        handle, _EIG_MODE_VECTOR, m, n, a.data_ptr(), m, S.data_ptr(), U.data_ptr(), m,
        V.data_ptr(), n, ctypes.byref(lwork), params, b), f"cusolverDn{x}gesvdjBatched_bufferSize")
    work = torch.empty((max(lwork.value, 1),), dtype=A.dtype, device=dev)
    _check(lib.cusolverDnSetStream(handle, torch.cuda.current_stream(dev).cuda_stream),
           "cusolverDnSetStream")
    _check(getattr(lib, f"cusolverDn{x}gesvdjBatched")(
        handle, _EIG_MODE_VECTOR, m, n, a.data_ptr(), m, S.data_ptr(), U.data_ptr(), m,
        V.data_ptr(), n, work.data_ptr(), lwork.value, info.data_ptr(), params, b),
        f"cusolverDn{x}gesvdjBatched")
    # Column-major U and V: U is the transpose of the buffer, Vh the buffer.
    return (U.transpose(-1, -2).reshape(batch + (m, m)), S.reshape(batch + (min(m, n),)),
            V.reshape(batch + (n, n)))
