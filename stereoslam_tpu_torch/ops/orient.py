"""Intensity-centroid keypoint orientation, the "IC_Angle" of ORB (port of
``stereoslam_tpu/ops/orient.py``; reference ORBextractor.cpp:27-55): every
keypoint's 31x31 patch is gathered at once and ``angle = atan2(m01, m10)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stereoslam_tpu_torch.ops.image import patch_at

HALF_PATCH = 15  # patch radius, reference ORBextractor.h HALF_PATCH_SIZE


@functools.lru_cache(maxsize=1)
def _moment_weights():
    """Circular-mask x/y coordinate weights (the reference's umax circle,
    ORBextractor.cpp:404-419, as the pixels within r + 0.5)."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    inside = (xs * xs + ys * ys) <= (r + 0.5) ** 2
    return (np.where(inside, xs, 0).astype(np.float32),
            np.where(inside, ys, 0).astype(np.float32))


@functools.lru_cache(maxsize=4)
def _moment_weights_on(device: torch.device):
    """The weights, copied to a device once."""
    return tuple(torch.from_numpy(w).to(device) for w in _moment_weights())


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Orientation (radians, in (-pi, pi]) per keypoint from the intensity
    centroid of the *unblurred* (H, W) level image around each (x, y)."""
    wx, wy = _moment_weights_on(img.device)
    patches = patch_at(img, xy, HALF_PATCH)              # (N, 31, 31)
    m10 = (patches * wx).sum(dim=(1, 2))
    m01 = (patches * wy).sum(dim=(1, 2))
    return torch.atan2(m01, m10)
