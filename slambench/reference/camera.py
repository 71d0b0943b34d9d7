"""Pinhole camera: a frozen copy of ``stereoslam_tpu_torch/ops/camera.py``
(without undistortion), part of the benchmark's plain reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import se3


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


def world2camera(p_w: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points -> camera frame (reference camera.cpp:9-12)."""
    return se3.act(T_cw, p_w)


def camera2pixel(p_c: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Project camera-frame points to pixels; depth clamped away from zero."""
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


def stereo_right_pose(baseline: float, device=None) -> torch.Tensor:
    """T of the right camera relative to the left: t = (-b, 0, 0)
    (reference system.cpp:116)."""
    T = torch.eye(4, dtype=torch.float32, device=device)
    T[0, 3] = -float(np.float32(baseline))
    return T
