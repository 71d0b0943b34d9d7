"""Image raster primitives for the LK pyramid (port of the LK part of
``stereoslam_tpu/ops/image.py``).

Images are ``(H, W)`` float32 tensors in [0, 255].  ``halve`` is the plain
2x2 mean; the JAX package's two-hot averaging matmul is a TPU idiom for the
same reduction.
"""

from __future__ import annotations

from typing import Tuple

import torch


def halve(img: torch.Tensor) -> torch.Tensor:
    """2x downsample by 2x2 averaging (the classic LK pyramid reduction);
    an odd last row/column is dropped."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).sum(dim=(1, 3)) * 0.25


def build_lk_pyramid(img: torch.Tensor, n_levels: int) -> Tuple[torch.Tensor, ...]:
    """Power-of-two pyramid for pyramidal LK (cv::buildOpticalFlowPyramid)."""
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(halve(levels[-1]))
    return tuple(levels)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``img`` (H, W) at float (x, y) coordinates
    ``xy`` (..., 2); coordinates are clamped to [0, size - 1.001]."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(-1)
    Ia = flat[y0 * w + x0]
    Ib = flat[y0 * w + x1]
    Ic = flat[y1 * w + x0]
    Id = flat[y1 * w + x1]
    return Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy) + Ic * (1 - fx) * fy + Id * fx * fy
