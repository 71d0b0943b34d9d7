"""One pyramidal-LK level: the CUDA kernel ``csrc/lk_level.cu``, its plain
PyTorch version and its build.

Replaces ``stereoslam_tpu/ops/lk_pallas.py::lk_level_pallas`` with the
semantics of the shipped TPU path, ``ops/lk_batched.py`` ``track_level_batched``:
flow clipped to +-BOUND px around the level's initial flow, bilinear taps on
integer indices clamped to the image (edge replication), template gradients
sampled at +-0.5 px without division, and the OpenCV-style min-eigenvalue
gate.  A feature that converged stops; that equals the masked fixed loop.

Entry points :func:`lk_level` and :func:`lk_final_error` run one level and
the final error alone, on the device code that ``ops/lk.py`` ``lk_pyramid``
launches for a whole call; they hold the kernel against its plain version
level by level.  :func:`window_plan` sizes the windows the kernel stages in
shared memory.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.  The kernel is compiled with ``nvcc`` at the first CUDA
call (never at import) into ``stereoslam_tpu_torch/_build/``, keyed by a hash
of the source, and bound with ctypes.  Each entry point's ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import torch

WINDOW = 11      # the window the kernel is compiled for (ops/lk_pallas.py WINDOW)
BOUND = 12.0     # per-level flow excursion (ops/lk_batched.py BOUND)
MIN_EIG = 1e-4   # min-eigenvalue gate per window sample (cv::calcOpticalFlowPyrLK default)
MAX_LEVELS = 8   # pyramid levels a kernel call takes (kMaxLevels in the source)

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "lk_level.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")


# ---------------------------------------------------------------------------
# The windows the kernel stages in shared memory
# ---------------------------------------------------------------------------

class WindowPlan(NamedTuple):
    template_pad: int       # template origin = integer base of the point - template_pad
    template_side: int
    search_pad: int         # search origin = integer base of point + level's initial flow - search_pad
    search_side: int
    pitch: int              # floats between the rows of either region in shared memory
    bytes_per_feature: int  # shared memory of one feature: both regions


def window_plan(window: int = WINDOW, bound: float = BOUND) -> WindowPlan:
    """Sizes of the two regions one feature stages per level.

    Template: the window, one px each side for the +-0.5 px gradient taps,
    and the second bilinear tap.  Search: the window, +-ceil(bound) px of
    clip around the level's start, one px each side for the rounding of
    (point + flow), and the second bilinear tap.  The rows of both are padded
    to a pitch equal to ``window`` mod 32, so window sample k falls on bank
    k mod 32.  The kernel refuses a launch whose size disagrees with its own.
    """
    r, clip = window // 2, math.ceil(bound)
    t_side = window + 3
    s_side = window + 2 * clip + 3
    pitch = s_side + (window - s_side) % 32
    return WindowPlan(r + 1, t_side, r + clip + 1, s_side, pitch, 4 * (t_side + s_side) * pitch)


def window_origins(pts: torch.Tensor, flow: torch.Tensor, window: int = WINDOW
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) origins (N, 2) int64 of the template and search regions the
    kernel stages for ``pts`` at a level whose initial flow is ``flow``."""
    plan = window_plan(window)
    base = torch.stack([_split(pts[:, i])[0] for i in (0, 1)], dim=-1)
    start = torch.stack([_split(pts[:, i] + flow[:, i])[0] for i in (0, 1)], dim=-1)
    return base - plan.template_pad, start - plan.search_pad


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
    min_eig: float = MIN_EIG,
    window: int = WINDOW,
    visit: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LK level for all N features.  Returns (flow (N, 2), good (N,)).

    ``visit(flow, active)``, where given, is called before each iteration
    with the flow it samples at and the (N,) mask of the features that run
    it (the kernel's loop stops for the others); chip_smoke.py counts the
    work of a call from it.
    """
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
        active = good & ~converged
        if visit is not None:
            visit(flow, active)
        r = _warp(img_next, pts, flow, window) - T
        b1 = (r * Ix).sum(1)
        b2 = (r * Iy).sum(1)
        step = torch.stack([-(inv11 * b1 + inv12 * b2), -(inv12 * b1 + inv22 * b2)], dim=-1)
        step = torch.where(active[:, None], step, torch.zeros_like(step))
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
    lib.lk_pyramid_launch.argtypes = [p, p, p, p, i, i, p, p, i, i, i, i, f, f, f, f, p, p, p,
                                      p, i, p]
    lib.lk_level_launch.argtypes = [p, p, i, i, p, p, p, p, i, i, f, f, i, p]
    lib.lk_final_error_launch.argtypes = [p, p, i, i, p, p, p, i, i, p]
    for fn in (lib.lk_pyramid_launch, lib.lk_level_launch, lib.lk_final_error_launch,
               lib.lk_window, lib.lk_max_levels):
        fn.restype = i
    lib.lk_window.argtypes = []
    lib.lk_max_levels.argtypes = []
    if (lib.lk_window(), lib.lk_max_levels()) != (WINDOW, MAX_LEVELS):
        raise RuntimeError(f"kernel built for window {lib.lk_window()} and {lib.lk_max_levels()} "
                           f"levels, expected {WINDOW} and {MAX_LEVELS}")
    return lib


def _check_tensor(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda_args(img_prev, img_next, pts, flow, window) -> None:
    dev = img_prev.device
    if window != WINDOW:
        raise ValueError(f"the LK kernel is compiled for a {WINDOW}x{WINDOW} window, got {window}")
    for name, t in (("img_prev", img_prev), ("img_next", img_next), ("pts", pts), ("flow", flow)):
        _check_tensor(name, t, dev)
    if img_prev.dim() != 2 or img_next.shape != img_prev.shape:
        raise ValueError(f"images must share one (H, W) shape: {img_prev.shape} vs {img_next.shape}")
    if pts.dim() != 2 or pts.shape[1] != 2 or flow.shape != pts.shape:
        raise ValueError(f"pts and flow must be (N, 2): {pts.shape} vs {flow.shape}")


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _launch_stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (take the plain version), True for CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {t.device}")
    return True


def lk_level(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    flow: torch.Tensor,
    iters: int,
    eps: float,
    min_eig: float = MIN_EIG,
    window: int = WINDOW,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LK level for all N features: (flow (N, 2), good (N,) bool)."""
    if not _on_cuda("lk_level", img_prev):
        return lk_level_plain(img_prev, img_next, pts, flow, iters, eps, min_eig, window)
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
            float(min_eig), window_plan().bytes_per_feature,
            _launch_stream(img_prev.device),
        )
    _check_launch(err, "lk_level")
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
    if not _on_cuda("lk_final_error", img_prev):
        return lk_final_error_plain(img_prev, img_next, pts, flow, window)
    _check_cuda_args(img_prev, img_next, pts, flow, window)
    lib = _library()
    H, W = img_prev.shape
    N = pts.shape[0]
    err_out = torch.empty((N,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(img_prev.device):
        err = lib.lk_final_error_launch(
            img_prev.data_ptr(), img_next.data_ptr(), H, W, pts.data_ptr(), flow.data_ptr(),
            err_out.data_ptr(), N, window_plan().bytes_per_feature,
            _launch_stream(img_prev.device),
        )
    _check_launch(err, "lk_final_error")
    lk_final_error.launches += 1
    return err_out


lk_level.launches = 0
lk_final_error.launches = 0
