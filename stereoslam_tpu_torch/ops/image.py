"""Image raster primitives: separable Gaussian blur, the 1.2x ORB pyramid,
the LK pyramid and bilinear sampling (port of ``stereoslam_tpu/ops/image.py``).

Images are ``(H, W)`` float32 tensors in [0, 255].  ``halve`` is the plain
2x2 mean; the JAX package's two-hot averaging matmul is a TPU idiom for the
same reduction.  Patches are gathered directly where the JAX package uses
one-hot selection matmuls (``extract_patches``), so it has no counterpart here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch


@functools.lru_cache(maxsize=16)
def _gaussian_taps(sigma: float, radius: int) -> tuple:
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _blur_axis(img: torch.Tensor, taps: tuple, dim: int) -> torch.Tensor:
    """One pass of the separable blur along ``dim`` with edge replication;
    the taps are added in order, as the JAX package adds its shifted views."""
    n = img.shape[dim]
    radius = len(taps) // 2
    idx = torch.arange(-radius, n + radius, device=img.device).clamp(0, n - 1)
    padded = img.index_select(dim, idx)
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        out = out + t * padded.narrow(dim, i, n)
    return out


def gaussian_blur(
    img: torch.Tensor,
    sigma: float = 2.0,
    radius: int = 3,
    sigma_x: Optional[float] = None,
    radius_x: Optional[int] = None,
) -> torch.Tensor:
    """Separable Gaussian blur with edge replication over the last two dims
    (the role of ``cv::GaussianBlur(image, 7, 7, 2, 2)`` before BRIEF sampling,
    reference ORBextractor.cpp:1200-1205).  Leading dims are a batch.

    ``sigma_x``/``radius_x``: optional separate horizontal kernel (anisotropic
    anti-aliasing before a non-uniform downscale); defaults to the vertical one.
    """
    taps = _gaussian_taps(float(sigma), int(radius))
    taps_x = _gaussian_taps(float(sigma_x), int(radius_x)) if sigma_x is not None else taps
    return _blur_axis(_blur_axis(img, taps, img.dim() - 2), taps_x, img.dim() - 1)


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> Tuple[Tuple[int, int], ...]:
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(8, int(round(h / s))), max(8, int(round(w / s)))))
    return tuple(shapes)


def _resize_weights(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_in, n_out) two-tap bilinear interpolation matrix (half-pixel
    centres, cv::resize INTER_LINEAR)."""
    scale = n_in / n_out
    centers = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    lo = torch.clamp(torch.floor(centers), 0, n_in - 1)
    frac = torch.clamp(centers - lo, 0.0, 1.0)
    hi = torch.clamp(lo + 1, max=n_in - 1)
    rows = torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
    return (rows == lo[None, :]) * (1.0 - frac[None, :]) + (rows == hi[None, :]) * frac[None, :]


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W) image as two matmuls with the separable
    two-tap weight matrices; leading dims of ``img`` are a batch."""
    h2, w2 = shape
    h, w = img.shape[-2:]
    Wh = _resize_weights(h2, h, img.device)   # (h, h2)
    Ww = _resize_weights(w2, w, img.device)   # (w, w2)
    return (Wh.T @ img) @ Ww


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> Tuple[torch.Tensor, ...]:
    """Image pyramid with the reference's 1.2x level spacing
    (ORBextractor.cpp:1229-1265): level 0 is the input, each level is resized
    bilinearly from the previous one."""
    shapes = pyramid_shapes(img.shape[0], img.shape[1], n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return tuple(levels)


def patch_at(img: torch.Tensor, centers_xy: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, 2r+1, 2r+1) square patches of an (H, W) image around the rounded
    (x, y) centres, clamped so each patch stays inside the image (the JAX
    package's ``extract_patches``, as a direct gather)."""
    h, w = img.shape
    cx = torch.clamp(torch.round(centers_xy[:, 0]).long(), radius, w - radius - 1)
    cy = torch.clamp(torch.round(centers_xy[:, 1]).long(), radius, h - radius - 1)
    off = torch.arange(-radius, radius + 1, device=img.device)
    flat = (cy[:, None, None] + off[None, :, None]) * w + (cx[:, None, None] + off[None, None, :])
    return img.reshape(-1)[flat]


def halve(img: torch.Tensor) -> torch.Tensor:
    """2x downsample by 2x2 averaging (the classic LK pyramid reduction);
    an odd last row/column is dropped.  Leading dims are a batch."""
    lead = img.shape[:-2]
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    return img[..., : h2 * 2, : w2 * 2].reshape(lead + (h2, 2, w2, 2)).sum(dim=(-3, -1)) * 0.25


def build_lk_pyramid(img: torch.Tensor, n_levels: int) -> Tuple[torch.Tensor, ...]:
    """Power-of-two pyramid for pyramidal LK (cv::buildOpticalFlowPyramid);
    leading dims of ``img`` are a batch."""
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(halve(levels[-1]))
    return tuple(levels)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``img`` (H, W) at float (x, y) coordinates
    ``xy`` (..., 2); coordinates are clamped to [0, size - 1.001].  A batch
    of images (B, H, W) takes coordinates (B, ..., 2), each image its own."""
    h, w = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    if img.dim() == 3:   # image b's pixels start at b * h * w of the flat view
        base = (torch.arange(img.shape[0], device=img.device) * (h * w)).reshape(
            (-1,) + (1,) * (x0.dim() - 1))
        x0, x1 = x0 + base, x1 + base
    flat = img.reshape(-1)
    Ia = flat[y0 * w + x0]
    Ib = flat[y0 * w + x1]
    Ic = flat[y1 * w + x0]
    Id = flat[y1 * w + x1]
    return Ia * (1 - fx) * (1 - fy) + Ib * fx * (1 - fy) + Ic * (1 - fx) * fy + Id * fx * fy
