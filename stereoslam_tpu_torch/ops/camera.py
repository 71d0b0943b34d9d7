"""Batched pinhole stereo camera operations (port of ``stereoslam_tpu/ops/camera.py``).

Same world<->camera<->pixel chain as the reference ``Camera`` class
(reference src/camera.cpp:9-48): ``pose`` is T_cw, and the right camera sits
at ``x = -baseline`` in the left camera frame (reference src/system.cpp:116).
Undistortion is not ported yet: ``StereoSlam`` refuses configs that need it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereoslam_tpu_torch.ops import se3


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as Python floats rounded to float32, so every op
    multiplies by the same constants the JAX package holds as f32 scalars."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "Intrinsics":
        return Intrinsics(*(float(np.float32(v)) for v in (fx, fy, cx, cy)))

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )


def world2camera(p_w: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points -> camera frame (reference camera.cpp:9-12)."""
    return se3.act(T_cw, p_w)


def camera2world(p_c: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    return se3.act(se3.inv(T_cw), p_c)


def camera2pixel(p_c: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Project camera-frame points to pixels; depth clamped away from zero
    (callers mask non-positive depth via :func:`depth_of`)."""
    z = p_c[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = intr.fx * p_c[..., 0] / z_safe + intr.cx
    v = intr.fy * p_c[..., 1] / z_safe + intr.cy
    return torch.stack([u, v], dim=-1)


def pixel2camera(px: torch.Tensor, intr: Intrinsics, depth=1.0) -> torch.Tensor:
    """Back-project pixels at the given depth (reference camera.cpp:26-30)."""
    depth = torch.as_tensor(depth, dtype=px.dtype, device=px.device)
    x = (px[..., 0] - intr.cx) / intr.fx * depth
    y = (px[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth.expand(x.shape)], dim=-1)


def world2pixel(p_w: torch.Tensor, T_cw: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    return camera2pixel(world2camera(p_w, T_cw), intr)


def pixel2world(px: torch.Tensor, T_cw: torch.Tensor, intr: Intrinsics, depth=1.0) -> torch.Tensor:
    return camera2world(pixel2camera(px, intr, depth), T_cw)


def depth_of(p_w: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """z in the camera frame, for cheirality masks."""
    return world2camera(p_w, T_cw)[..., 2]


def stereo_right_pose(baseline: float, device=None) -> torch.Tensor:
    """T of the right camera relative to the left: t = (-b, 0, 0)
    (reference system.cpp:116)."""
    T = torch.eye(4, dtype=torch.float32, device=device)
    T[0, 3] = -float(np.float32(baseline))
    return T
