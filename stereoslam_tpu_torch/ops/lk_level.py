"""One pyramidal-LK level: the CUDA kernel ``csrc/lk_level.cu`` and its plain
PyTorch version.

Replaces ``stereoslam_tpu/ops/lk_pallas.py::lk_level_pallas`` with the
semantics of the shipped TPU path, ``ops/lk_batched.py`` ``track_level_batched``:
flow clipped to +-BOUND px around the level's initial flow, bilinear taps on
integer indices clamped to the image (edge replication), template gradients
sampled at +-0.5 px without division, and the OpenCV-style min-eigenvalue
gate.  A feature that converged stops; that equals the masked fixed loop.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.  The kernel is compiled with ``nvcc`` at the first CUDA
call (never at import) into ``stereoslam_tpu_torch/_build/``, keyed by a hash
of the source, and bound with ctypes.  ``lk_level.launches`` and
``lk_final_error.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

WINDOW = 11      # the window the kernel is compiled for (ops/lk_pallas.py WINDOW)
BOUND = 12.0     # per-level flow excursion (ops/lk_batched.py BOUND)

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "lk_level.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")


# ---------------------------------------------------------------------------
# Plain PyTorch version (all N features vectorized over (N, window^2) grids)
# ---------------------------------------------------------------------------

def _split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer part (as int64, clamped like the kernel's) and fraction."""
    f = torch.floor(v)
    return torch.clamp(f, -64.0, 16777216.0).long(), v - f


def _sample(img: torch.Tensor, by, bx, fy, fx) -> torch.Tensor:
    """Bilinear sample at integer bases (by, bx) + fractions (fy, fx); taps
    clamped to the image."""
    H, W = img.shape
    y0, y1 = by.clamp(0, H - 1), (by + 1).clamp(0, H - 1)
    x0, x1 = bx.clamp(0, W - 1), (bx + 1).clamp(0, W - 1)
    flat = img.reshape(-1)
    return (flat[y0 * W + x0] * (1 - fy) * (1 - fx) + flat[y0 * W + x1] * (1 - fy) * fx
            + flat[y1 * W + x0] * fy * (1 - fx) + flat[y1 * W + x1] * fy * fx)


def _offsets(window: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    r = window // 2
    ar = torch.arange(-r, r + 1, device=device)
    return ar.repeat_interleave(window), ar.repeat(window)  # (dy, dx) per sample


def _template(img_prev, pts, window):
    oy, ox = _offsets(window, pts.device)
    px, py = pts[:, 0:1], pts[:, 1:2]
    (bx, ax), (by, ay) = _split(px), _split(py)
    (bxm, axm), (bxp, axp) = _split(px - 0.5), _split(px + 0.5)
    (bym, aym), (byp, ayp) = _split(py - 0.5), _split(py + 0.5)
    T = _sample(img_prev, by + oy, bx + ox, ay, ax)
    Ix = (_sample(img_prev, by + oy, bxp + ox, ay, axp)
          - _sample(img_prev, by + oy, bxm + ox, ay, axm))
    Iy = (_sample(img_prev, byp + oy, bx + ox, ayp, ax)
          - _sample(img_prev, bym + oy, bx + ox, aym, ax))
    return T, Ix, Iy


def _warp(img_next, pts, flow, window):
    oy, ox = _offsets(window, pts.device)
    (jx, ajx), (jy, ajy) = _split(pts[:, 0:1] + flow[:, 0:1]), _split(pts[:, 1:2] + flow[:, 1:2])
    return _sample(img_next, jy + oy, jx + ox, ajy, ajx)


def lk_level_plain(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    flow: torch.Tensor,
    iters: int,
    eps: float,
    min_eig: float = 1e-4,
    window: int = WINDOW,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LK level for all N features.  Returns (flow (N, 2), good (N,))."""
    T, Ix, Iy = _template(img_prev, pts, window)
    g11 = (Ix * Ix).sum(1)
    g12 = (Ix * Iy).sum(1)
    g22 = (Iy * Iy).sum(1)
    det = g11 * g22 - g12 * g12
    trace = g11 + g22
    min_eig_val = (trace - torch.sqrt(torch.clamp(trace * trace - 4.0 * det, min=0.0))) * 0.5
    good = min_eig_val / (window * window) > min_eig
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv11, inv12, inv22 = g22 / det_safe, -g12 / det_safe, g11 / det_safe

    flow0 = flow
    converged = ~good
    for _ in range(iters):
        r = _warp(img_next, pts, flow, window) - T
        b1 = (r * Ix).sum(1)
        b2 = (r * Iy).sum(1)
        step = torch.stack([-(inv11 * b1 + inv12 * b2), -(inv12 * b1 + inv22 * b2)], dim=-1)
        step = torch.where((good & ~converged)[:, None], step, torch.zeros_like(step))
        flow = torch.minimum(torch.maximum(flow + step, flow0 - BOUND), flow0 + BOUND)
        converged = converged | ((step * step).sum(-1) < eps * eps)
    return flow, good


def lk_final_error_plain(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    flow: torch.Tensor,
    window: int = WINDOW,
) -> torch.Tensor:
    """Mean |J - T| over the window at ``flow`` (ops/lk.py ``_final_error``)."""
    T, _, _ = _template(img_prev, pts, window)
    return (_warp(img_next, pts, flow, window) - T).abs().mean(1)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the LK kernel needs the CUDA toolkit to build")


def build_library() -> Path:
    """Compile ``csrc/lk_level.cu`` for sm_90a unless a build of this exact
    source already exists; returns the shared library's path."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"lk_level_{digest}.so"
    if not lib.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_level_launch.argtypes = [p, p, i, i, p, p, p, p, i, i, f, f, p]
    lib.lk_level_launch.restype = i
    lib.lk_final_error_launch.argtypes = [p, p, i, i, p, p, p, i, p]
    lib.lk_final_error_launch.restype = i
    lib.lk_window.argtypes = []
    lib.lk_window.restype = i
    if lib.lk_window() != WINDOW:
        raise RuntimeError(f"kernel built for window {lib.lk_window()}, expected {WINDOW}")
    return lib


def _check_cuda_args(img_prev, img_next, pts, flow, window) -> None:
    dev = img_prev.device
    if window != WINDOW:
        raise ValueError(f"the LK kernel is compiled for a {WINDOW}x{WINDOW} window, got {window}")
    for name, t in (("img_prev", img_prev), ("img_next", img_next), ("pts", pts), ("flow", flow)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if img_prev.dim() != 2 or img_next.shape != img_prev.shape:
        raise ValueError(f"images must share one (H, W) shape: {img_prev.shape} vs {img_next.shape}")
    if pts.dim() != 2 or pts.shape[1] != 2 or flow.shape != pts.shape:
        raise ValueError(f"pts and flow must be (N, 2): {pts.shape} vs {flow.shape}")


def _launch_stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def lk_level(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    flow: torch.Tensor,
    iters: int,
    eps: float,
    min_eig: float = 1e-4,
    window: int = WINDOW,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LK level for all N features: (flow (N, 2), good (N,) bool)."""
    if img_prev.device.type == "cpu":
        return lk_level_plain(img_prev, img_next, pts, flow, iters, eps, min_eig, window)
    if img_prev.device.type != "cuda":
        raise ValueError(f"lk_level runs on CPU or CUDA tensors, got {img_prev.device}")
    _check_cuda_args(img_prev, img_next, pts, flow, window)
    lib = _library()
    H, W = img_prev.shape
    N = pts.shape[0]
    flow_out = torch.empty_like(flow)
    good = torch.empty((N,), dtype=torch.bool, device=pts.device)
    with torch.cuda.device(img_prev.device):
        err = lib.lk_level_launch(
            img_prev.data_ptr(), img_next.data_ptr(), H, W, pts.data_ptr(), flow.data_ptr(),
            flow_out.data_ptr(), good.data_ptr(), N, int(iters), float(eps * eps),
            float(min_eig), _launch_stream(img_prev.device),
        )
    if err != 0:
        raise RuntimeError(f"lk_level kernel launch failed with CUDA error {err}")
    lk_level.launches += 1
    return flow_out, good


def lk_final_error(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    flow: torch.Tensor,
    window: int = WINDOW,
) -> torch.Tensor:
    """Mean |J - T| over the window at ``flow``: (N,) float32."""
    if img_prev.device.type == "cpu":
        return lk_final_error_plain(img_prev, img_next, pts, flow, window)
    if img_prev.device.type != "cuda":
        raise ValueError(f"lk_final_error runs on CPU or CUDA tensors, got {img_prev.device}")
    _check_cuda_args(img_prev, img_next, pts, flow, window)
    lib = _library()
    H, W = img_prev.shape
    N = pts.shape[0]
    err_out = torch.empty((N,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(img_prev.device):
        err = lib.lk_final_error_launch(
            img_prev.data_ptr(), img_next.data_ptr(), H, W, pts.data_ptr(), flow.data_ptr(),
            err_out.data_ptr(), N, _launch_stream(img_prev.device),
        )
    if err != 0:
        raise RuntimeError(f"lk_final_error kernel launch failed with CUDA error {err}")
    lk_final_error.launches += 1
    return err_out


lk_level.launches = 0
lk_final_error.launches = 0
