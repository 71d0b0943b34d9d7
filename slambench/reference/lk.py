"""Pyramidal Lucas-Kanade in plain PyTorch: a frozen copy of the plain
version of ``stereoslam_tpu_torch/ops/lk_level.py`` (one level, the final
error, the windows the kernel stages) and of ``ops/lk.py``'s composition of a
call, part of the benchmark's plain reference.  ``roofline/lk_work.py``
counts the work of a kernel launch through :func:`lk_level_plain`'s
``visit`` hook, so the count stays the same whatever implements the kernel.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

WINDOW = 11      # the LK window (cv::Size(11, 11))
BOUND = 12.0     # per-level flow excursion, px
MIN_EIG = 1e-4   # min-eigenvalue gate per window sample (cv::calcOpticalFlowPyrLK default)


class WindowPlan(NamedTuple):
    template_pad: int
    template_side: int
    search_pad: int
    search_side: int


def window_plan(window: int = WINDOW, bound: float = BOUND) -> WindowPlan:
    """Sizes of the template region (the window, one px each side for the
    +-0.5 px gradient taps, and the second bilinear tap) and of the search
    region (the window, +-ceil(bound) px of clip, one px each side for the
    rounding of point + flow, and the second bilinear tap)."""
    r, clip = window // 2, math.ceil(bound)
    return WindowPlan(r + 1, window + 3, r + clip + 1, window + 2 * clip + 3)


def window_origins(pts: torch.Tensor, flow: torch.Tensor, window: int = WINDOW
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) integer origins (N, 2) of the template and search regions of
    ``pts`` at a level whose initial flow is ``flow``."""
    plan = window_plan(window)
    base = torch.stack([split(pts[:, i])[0] for i in (0, 1)], dim=-1)
    start = torch.stack([split(pts[:, i] + flow[:, i])[0] for i in (0, 1)], dim=-1)
    return base - plan.template_pad, start - plan.search_pad


def split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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
    (bx, ax), (by, ay) = split(px), split(py)
    (bxm, axm), (bxp, axp) = split(px - 0.5), split(px + 0.5)
    (bym, aym), (byp, ayp) = split(py - 0.5), split(py + 0.5)
    T = _sample(img_prev, by + oy, bx + ox, ay, ax)
    Ix = (_sample(img_prev, by + oy, bxp + ox, ay, axp)
          - _sample(img_prev, by + oy, bxm + ox, ay, axm))
    Iy = (_sample(img_prev, byp + oy, bx + ox, ayp, ax)
          - _sample(img_prev, bym + oy, bx + ox, aym, ax))
    return T, Ix, Iy


def _warp(img_next, pts, flow, window):
    oy, ox = _offsets(window, pts.device)
    (jx, ajx), (jy, ajy) = split(pts[:, 0:1] + flow[:, 0:1]), split(pts[:, 1:2] + flow[:, 1:2])
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
    it (a converged feature stops).
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


def lk_final_error_plain(img_prev, img_next, pts, flow, window: int = WINDOW) -> torch.Tensor:
    """Mean |J - T| over the window at ``flow``."""
    T, _, _ = _template(img_prev, pts, window)
    return (_warp(img_next, pts, flow, window) - T).abs().mean(1)


class FlowResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions in the next image
    status: torch.Tensor  # (N,) bool
    error: torch.Tensor   # (N,) mean |residual| over the window


def pyramidal_lk(
    pyr_prev: Sequence[torch.Tensor],
    pyr_next: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,
    pts_init: torch.Tensor,
    window: int = WINDOW,
    iters: int = 30,
    eps: float = 0.01,
    max_error: float = 30.0,
    forward_backward: float = 0.0,
    fb_iters: int = 10,
    fb_levels: int = 0,
    gate: Optional[bool] = None,
) -> FlowResult:
    """A pyramidal-LK call, coarse to fine, seeded at ``pts_init``; the
    conditioning gate at the finest level; the forward-backward check where
    ``forward_backward`` > 0.  ``gate`` False: the call keeps no track."""
    if gate is not None and not gate:
        n = pts_init.shape[0]
        return FlowResult(pts_init.clone(), torch.zeros((n,), dtype=torch.bool,
                                                        device=pts_init.device),
                          torch.zeros((n,), dtype=torch.float32, device=pts_init.device))
    n_levels = len(pyr_prev)
    flow = (pts_init - pts_prev) / float(2 ** (n_levels - 1))
    good_all = torch.ones(pts_prev.shape[0], dtype=torch.bool, device=pts_prev.device)
    for lvl in range(n_levels - 1, -1, -1):
        flow, good = lk_level_plain(pyr_prev[lvl], pyr_next[lvl], pts_prev / float(2 ** lvl),
                                    flow, iters, eps, window=window)
        if lvl == 0:
            good_all = good_all & good
        else:
            flow = flow * 2.0
    pts_next = pts_prev + flow
    h, w = pyr_next[0].shape
    margin = window // 2
    in_bounds = ((pts_next[:, 0] >= margin) & (pts_next[:, 0] < w - margin)
                 & (pts_next[:, 1] >= margin) & (pts_next[:, 1] < h - margin))
    err = lk_final_error_plain(pyr_prev[0], pyr_next[0], pts_prev, flow, window)
    status = good_all & in_bounds & (err < max_error)
    if forward_backward > 0.0:
        fb_next = pyr_next[:fb_levels] if fb_levels > 0 else pyr_next
        fb_prev = pyr_prev[:fb_levels] if fb_levels > 0 else pyr_prev
        back = pyramidal_lk(fb_next, fb_prev, pts_next, pts_next, window=window, iters=fb_iters,
                            eps=eps, max_error=max_error)
        round_trip = torch.linalg.norm(back.points - pts_prev, dim=-1)
        status = status & back.status & (round_trip <= forward_backward)
    return FlowResult(points=pts_next, status=status, error=err)
