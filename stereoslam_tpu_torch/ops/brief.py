"""Rotation-steered BRIEF-256 descriptors (port of
``stereoslam_tpu/ops/brief.py``; reference ORBextractor.cpp:58-98).

The 256 point pairs are the JAX package's generated pattern (isotropic
Gaussian N(0, (31/5)^2) offsets clipped to +-13 px, numpy seed 20240331), so
descriptors of the two packages match bit for bit.  Each rotated offset is
rounded to the nearest pixel and clamped into the 41x41 window around the
keypoint's clamped centre, and sampled there directly; the JAX package's
one-hot row matmul plus column mask selects exactly that one value.

The 256 bits pack into eight 32-bit words, bit ``k`` of word ``j`` being pair
``32 j + k``.  ``torch.uint32`` supports few operations, so the words are held
as ``int32`` with the same bits (a word with bit 31 set is negative).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_BITS = 256
N_WORDS = 8
PATCH_RADIUS = 13  # sample offsets stay within +/-13 like the reference table
WINDOW_RADIUS = PATCH_RADIUS + 7  # rotated offset <= 13*sqrt(2) ~ 18.4, +1 rounding


@functools.lru_cache(maxsize=1)
def _pattern() -> np.ndarray:
    """(256, 2, 2) float32: per bit, two (x, y) offsets."""
    rng = np.random.default_rng(20240331)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _pattern_on(device: torch.device) -> torch.Tensor:
    """The pattern, copied to a device once."""
    return torch.from_numpy(_pattern()).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words holding the uint32 bit pattern."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def brief_descriptors(img_blurred: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF of the Gaussian-blurred (H, W) level image at (N, 2)
    centres with (N,) orientations in radians.  Returns (N, 8) int32 words
    (the uint32 bit patterns of the JAX package)."""
    pat = _pattern_on(xy.device)
    c, s = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    px, py = pat[None, ..., 0], pat[None, ..., 1]
    rx = c * px - s * py                                         # (N, 256, 2)
    ry = s * px + c * py
    h, w = img_blurred.shape
    R = WINDOW_RADIUS
    acx = torch.clamp(torch.round(xy[:, 0]).long(), R, w - R - 1)[:, None, None]
    acy = torch.clamp(torch.round(xy[:, 1]).long(), R, h - R - 1)[:, None, None]
    sx = torch.round(xy[:, None, None, 0] + rx).long()
    sy = torch.round(xy[:, None, None, 1] + ry).long()
    sx = torch.minimum(torch.maximum(sx, acx - R), acx + R)
    sy = torch.minimum(torch.maximum(sy, acy - R), acy + R)
    vals = img_blurred.reshape(-1)[sy * w + sx]                  # (N, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])
