"""The tracked frame in plain PyTorch: a frozen copy of
``stereoslam_tpu_torch/core/frontend.py`` ``track_step`` up to the frame's
pose (the LK seeds by landmark reprojection under the constant-velocity
prior, pyramidal LK with its two rescue passes, the pose-only robust LM and
the trust region), part of the benchmark's plain reference.  It reads the rescue
decisions on the host and takes its settings from the configuration file's
``slam`` section, as plain dicts.

It starts from the program's state before the frame (its tracks, its pose
relative to the reference keyframe, its velocity, the map's landmarks and
keyframe poses): a tracked frame cannot be recomputed from the frames alone,
since every frame carries the state of all frames before it.  The two images
come from the benchmark's own frames, and the reference builds their
pyramids itself.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from slambench.reference import se3
from slambench.reference.camera import Intrinsics, world2pixel
from slambench.reference.image import build_lk_pyramid, halve
from slambench.reference.lk import FlowResult, pyramidal_lk
from slambench.reference.lm import optimize_pose


class TrackIn(NamedTuple):
    """The program's state before a tracked frame, as the reference reads it."""

    xy: torch.Tensor          # (N, 2) track positions in the previous left image
    lm_idx: torch.Tensor      # (N,) landmark id or -1
    valid: torch.Tensor       # (N,) bool
    T_rk: torch.Tensor        # (4, 4) pose relative to the reference keyframe
    T_vel: torch.Tensor       # (4, 4) constant-velocity model
    ref_kf: int
    lm_pos: torch.Tensor      # (L, 3)
    lm_valid: torch.Tensor    # (L,) bool
    lm_outlier: torch.Tensor  # (L,) bool
    kf_T_cw: torch.Tensor     # (K, 4, 4)


class TrackOut(NamedTuple):
    xy: torch.Tensor       # (N, 2) track positions in the current left image
    valid: torch.Tensor    # (N,) bool
    T_rk: torch.Tensor     # (4, 4) pose relative to the reference keyframe


def max_pyramid_depth(h: int, w: int, window: int) -> int:
    """Deepest pyramid with no level under about two LK windows."""
    return max(1, int(math.floor(math.log2(min(h, w) / (2.0 * window)))) + 1)


def _extend(pyr: Sequence[torch.Tensor], n_levels: int):
    pyr = list(pyr)
    while len(pyr) < n_levels:
        pyr.append(halve(pyr[-1]))
    return tuple(pyr[:n_levels])


def _merge(f1: FlowResult, f2: FlowResult, fail: torch.Tensor) -> FlowResult:
    use2 = fail & f2.status
    return FlowResult(points=torch.where(use2[:, None], f2.points, f1.points),
                      status=f1.status | use2, error=torch.where(use2, f2.error, f1.error))


def track(s: TrackIn, prev_u8: torch.Tensor, cur_u8: torch.Tensor, intr: Intrinsics,
          tracking: dict, features: dict) -> TrackOut:
    """One tracked frame from ``s``: ``prev_u8`` and ``cur_u8`` are the
    previous and current left images (H, W) uint8."""
    t = tracking
    pyr_prev = build_lk_pyramid(prev_u8.to(torch.float32), t["lk_levels"])
    pyr_cur = build_lk_pyramid(cur_u8.to(torch.float32), t["lk_levels"])
    eye = torch.eye(4, dtype=s.T_rk.dtype, device=s.T_rk.device)
    T_kf = s.kf_T_cw[s.ref_kf] if s.ref_kf >= 0 else eye
    T_pred = s.T_vel @ s.T_rk @ T_kf

    safe = torch.clamp(s.lm_idx, min=0).long()
    lm_pos = s.lm_pos[safe]
    has_lm = s.valid & (s.lm_idx >= 0) & s.lm_valid[safe] & ~s.lm_outlier[safe]
    init_px = torch.where(has_lm[:, None], world2pixel(lm_pos, T_pred, intr), s.xy)

    kw = dict(window=t["lk_window"], iters=t["lk_iters"], eps=t["lk_eps"],
              forward_backward=t["lk_forward_backward"], fb_levels=t["lk_fb_levels"],
              fb_iters=t["lk_fb_iters"])
    flow = pyramidal_lk(pyr_prev, pyr_cur, s.xy, init_px, **kw)
    if t["lk_retry_fail_frac"] > 0:
        n_valid = torch.clamp(s.valid.sum(), min=1).to(torch.float32)
        fail = s.valid & ~flow.status
        retry = bool(fail.sum() > n_valid * t["lk_retry_fail_frac"])
        flow = _merge(flow, pyramidal_lk(pyr_prev, pyr_cur, s.xy, s.xy, gate=retry, **kw), fail)
        h0, w0 = pyr_prev[0].shape
        deep_n = min(len(pyr_prev) + t["lk_rescue_extra_levels"],
                     max_pyramid_depth(h0, w0, t["lk_window"]))
        if t["lk_rescue_extra_levels"] > 0 and deep_n > len(pyr_prev):
            fail2 = s.valid & ~flow.status
            deep = bool(fail2.sum() > n_valid * t["lk_deep_rescue_frac"])
            f2 = pyramidal_lk(_extend(pyr_prev, deep_n), _extend(pyr_cur, deep_n), s.xy, s.xy,
                              gate=deep, **kw)
            flow = _merge(flow, f2, fail2)

    alive = s.valid & flow.status
    tracked = alive & has_lm
    res = optimize_pose(T_pred, lm_pos, flow.points, tracked, intr, rounds=t["pose_rounds"],
                        iters=t["pose_iters"], chi2_threshold=t["chi2_threshold"], host_exit=True)
    T_sol = res.T_cw
    if t["pose_trust_factor"] > 0:
        dx_n = torch.linalg.norm(se3.log(res.T_cw @ se3.inv(T_pred)))
        vel_n = torch.linalg.norm(se3.log(s.T_vel))
        if bool((res.num_inliers < features["num_features_tracking_good"])
                & (dx_n > t["pose_trust_factor"] * vel_n + t["pose_trust_min"])):
            T_sol = T_pred
    T_rk = se3.orthonormalize(T_sol @ se3.inv(T_kf))
    return TrackOut(xy=flow.points, valid=alive, T_rk=T_rk)
