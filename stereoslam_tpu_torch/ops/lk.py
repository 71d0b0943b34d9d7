"""Batched pyramidal Lucas-Kanade optical flow (port of ``stereoslam_tpu/ops/lk.py``).

Replaces ``cv::calcOpticalFlowPyrLK`` as the reference uses it (reference
src/frontend.cpp:150-153, 355-360; OPTFLOW_USE_INITIAL_FLOW).  All N tracks
advance together, one level at a time, through :func:`lk_level` (the CUDA
kernel on a card, its plain version on the CPU).  The JAX package's
three-way ``STEREOSLAM_LK`` switch is gone: the port has one level
implementation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from stereoslam_tpu_torch.ops.lk_level import lk_final_error, lk_level


class FlowResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions in the next image
    status: torch.Tensor  # (N,) bool — track considered successful
    error: torch.Tensor   # (N,) float32 mean |residual| over the window


def pyramidal_lk(
    pyr_prev: Sequence[torch.Tensor],
    pyr_next: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,
    pts_init: torch.Tensor,
    window: int = 11,
    iters: int = 30,
    eps: float = 0.01,
    max_error: float = 30.0,
    forward_backward: float = 0.0,
    fb_iters: int = 10,
    fb_levels: int = 0,
) -> FlowResult:
    """Track ``pts_prev`` (N, 2) from ``pyr_prev`` to ``pyr_next`` (finest
    level first), seeded at ``pts_init``.

    Conditioning (``good``) gates only at the finest level, as in OpenCV.
    ``forward_backward`` > 0 re-tracks the result back (seeded at zero
    flow, ``fb_iters`` iterations, the finest ``fb_levels`` levels, 0 = all)
    and rejects tracks whose round trip misses the start by more than that
    many pixels — the guard against ghost locks from biased seeds.
    """
    n_levels = len(pyr_prev)
    flow = (pts_init - pts_prev) / float(2 ** (n_levels - 1))
    good_all = torch.ones(pts_prev.shape[0], dtype=torch.bool, device=pts_prev.device)
    for lvl in range(n_levels - 1, -1, -1):
        pts_l = (pts_prev / float(2 ** lvl)).contiguous()
        flow, good = lk_level(pyr_prev[lvl], pyr_next[lvl], pts_l, flow.contiguous(),
                              iters=iters, eps=eps, window=window)
        if lvl == 0:
            good_all = good_all & good
        else:
            flow = flow * 2.0

    pts_next = pts_prev + flow
    h, w = pyr_next[0].shape
    margin = window // 2
    in_bounds = (
        (pts_next[:, 0] >= margin) & (pts_next[:, 0] < w - margin)
        & (pts_next[:, 1] >= margin) & (pts_next[:, 1] < h - margin)
    )
    err = lk_final_error(pyr_prev[0], pyr_next[0], pts_prev.contiguous(), flow.contiguous(),
                         window=window)
    status = good_all & in_bounds & (err < max_error)

    if forward_backward > 0.0:
        fb_next = pyr_next[:fb_levels] if fb_levels > 0 else pyr_next
        fb_prev = pyr_prev[:fb_levels] if fb_levels > 0 else pyr_prev
        back = pyramidal_lk(fb_next, fb_prev, pts_next, pts_next, window=window,
                            iters=fb_iters, eps=eps, max_error=max_error)
        round_trip = torch.linalg.norm(back.points - pts_prev, dim=-1)
        status = status & back.status & (round_trip <= forward_backward)
    return FlowResult(points=pts_next, status=status, error=err)
