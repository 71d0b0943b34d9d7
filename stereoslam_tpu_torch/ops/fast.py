"""FAST-9/16 corner detection + spatially-uniform keypoint selection
(port of ``stereoslam_tpu/ops/fast.py``).

Dual-threshold FAST (reference ORBextractor.cpp:998-1074) over the whole
image as 16 shifted views, 3x3 non-maximum suppression with the reference's
row-major tie rule, then per-cell top-M and a global top-K standing in for
``DistributeOctTree`` (ORBextractor.cpp:586-810).  ``lax.top_k`` prefers the
lower index on ties and ``torch.topk`` promises no order, so both top-k
steps here are stable descending sorts, which give the same sets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — (dx, dy), the standard FAST-16 ring.
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_ARC_LEN = 9  # FAST-9: at least 9 contiguous circle pixels all brighter/darker


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set. Invalid slots have valid=False, xy=0."""

    xy: torch.Tensor     # (N, 2) float32, (x, y)
    score: torch.Tensor  # (N,) float32 corner response
    valid: torch.Tensor  # (N,) bool


def _ring_diffs(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) differences circle_pixel - center, via wrapped views."""
    shifted = [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) for (dx, dy) in _CIRCLE]
    return torch.stack(shifted, dim=0) - img[None]


def _contiguous_arc(mask16: torch.Tensor) -> torch.Tensor:
    """True where any 9 contiguous bits of the 16-bit ring mask are set.
    int64 holds the doubled (wrap-around) 32-bit ring without sign trouble."""
    bits = torch.zeros(mask16.shape[1:], dtype=torch.int64, device=mask16.device)
    for k in range(16):
        bits = bits | (mask16[k].to(torch.int64) << k)
    wrapped = bits | (bits << 16)
    acc = wrapped
    for s in range(1, _ARC_LEN):
        acc = acc & (wrapped >> s)
    return acc != 0


def fast_response(img: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image FAST-9 corner mask + response (sum of |ring - center|
    excess over the threshold on the dominant side).

    Returns (corner (H, W) bool, score (H, W) float32).
    """
    d = _ring_diffs(img)
    is_corner = _contiguous_arc(d > threshold) | _contiguous_arc(d < -threshold)
    score = torch.maximum(torch.clamp(d - threshold, min=0.0).sum(0),
                          torch.clamp(-d - threshold, min=0.0).sum(0))
    return is_corner, torch.where(is_corner, score, torch.zeros_like(score))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: strict against the top-left neighbours
    (OpenCV's row-major scan wins those ties), >= against the others."""
    padded = F.pad(score[None, None], (1, 1, 1, 1), value=-1.0)[0, 0]
    h, w = score.shape
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            keep = keep & ((score > neigh) if (dy, dx) < (0, 0) else (score >= neigh))
    return torch.where(keep, score, torch.zeros_like(score))


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last dim: largest first, the lower
    index first among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_keypoints(
    img: torch.Tensor,
    n_features: int,
    ini_threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell_size: int = 16,
    border: int = 20,
    forbid_mask: Optional[torch.Tensor] = None,
) -> Keypoints:
    """Detect up to ``n_features`` spatially-distributed FAST keypoints
    (ORBextractor::Detect, ORBextractor.cpp:984-1080).  High-threshold
    corners outrank low-threshold ones (BONUS), and per-cell candidates are
    ranked coverage-first (every cell's best before any cell's second).
    ``forbid_mask``: optional (H, W) bool, True where detection is forbidden.
    """
    h, w = img.shape
    dev = img.device
    _, score_hi = fast_response(img, ini_threshold)
    _, score_lo = fast_response(img, min_threshold)
    BONUS = 4096.0  # keys stay below 2^17, inside f32's exact-ulp range
    score_hi = torch.clamp(_nms3(score_hi), max=4095.0)
    score_lo = torch.clamp(_nms3(score_lo), max=4095.0)
    score = torch.where(score_hi > 0.0, score_hi + BONUS, score_lo)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(in_border, score, torch.zeros_like(score))
    if forbid_mask is not None:
        score = torch.where(forbid_mask, torch.zeros_like(score), score)

    ch = -(-h // cell_size) * cell_size
    cw = -(-w // cell_size) * cell_size
    padded = F.pad(score, (0, cw - w, 0, ch - h))
    ncy, ncx = ch // cell_size, cw // cell_size
    cells = padded.reshape(ncy, cell_size, ncx, cell_size).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell_size * cell_size)
    n_cells = ncy * ncx
    interior_cells = max(1, ((h - 2 * border) // cell_size) * ((w - 2 * border) // cell_size))
    # Several keypoints per cell only on real starvation (fast.py:175-184).
    if interior_cells >= 0.7 * n_features:
        m = 1
    else:
        m = min(8, max(1, -(-n_features // interior_cells)))

    top_m_scores, top_m_arg = _top_k(cells, m)                           # (C, m)
    rank_tier = (m - 1 - torch.arange(m, dtype=score.dtype, device=dev)) * (4.0 * BONUS)
    ranked = torch.where(top_m_scores > 0.0, top_m_scores + rank_tier[None, :],
                         torch.zeros_like(top_m_scores))

    k = min(n_features, n_cells * m)
    top_ranked, top_flat = _top_k(ranked.reshape(-1), k)
    cell_idx = top_flat // m
    in_cell = top_m_arg.reshape(-1)[top_flat]
    py = (cell_idx // ncx) * cell_size + in_cell // cell_size
    px = (cell_idx % ncx) * cell_size + in_cell % cell_size

    valid = top_ranked > 0.0
    xy = torch.stack([px, py], dim=-1).to(torch.float32)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    raw = cells.reshape(-1)[cell_idx * (cell_size * cell_size) + in_cell]
    resp = torch.where(raw >= BONUS, raw - BONUS, raw)

    if k < n_features:
        pad = n_features - k
        xy = torch.cat([xy, torch.zeros((pad, 2), dtype=torch.float32, device=dev)])
        resp = torch.cat([resp, torch.zeros((pad,), dtype=resp.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return Keypoints(xy=xy, score=torch.where(valid, resp, torch.zeros_like(resp)), valid=valid)


def fast_corner_check_at(img: torch.Tensor, xy: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 cornerness at sparse (x, y) positions only (reference
    isFastCorner, ORBextractor.cpp:449-511): the 16-pixel ring of each
    rounded position, with the centre clamped 3 px inside the image, gathered
    from the 7x7 patch around it.  Returns (N,) bool."""
    from stereoslam_tpu_torch.ops.image import patch_at

    patches = patch_at(img, xy, 3)                       # (N, 7, 7), centre at (3, 3)
    ring = torch.stack([patches[:, 3 + dy, 3 + dx] for (dx, dy) in _CIRCLE], dim=0)
    d = ring - patches[None, :, 3, 3]
    return _contiguous_arc(d > threshold) | _contiguous_arc(d < -threshold)


def forbid_mask_from_points(
    h: int, w: int, xy: torch.Tensor, valid: torch.Tensor, radius: int = 10
) -> torch.Tensor:
    """Rasterize "no new detections near existing features" (the rectangle
    mask of frontend.cpp:305-309): a (2r+1)^2 box around each valid point,
    shifted inside the image at the borders.  The JAX package splats the
    boxes one by one (``lax.scan``); one ``index_add_`` over every box pixel
    gives the same mask."""
    size = 2 * radius + 1
    dev = xy.device
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64) - radius, 0, w - size)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64) - radius, 0, h - size)
    off = torch.arange(size, device=dev)
    rows = (y0[:, None] + off[None, :])[:, :, None]                     # (N, size, 1)
    cols = (x0[:, None] + off[None, :])[:, None, :]                     # (N, 1, size)
    flat = (rows * w + cols).reshape(-1)
    hits = valid.to(torch.int32)[:, None].expand(-1, size * size).reshape(-1)
    mask = torch.zeros(h * w, dtype=torch.int32, device=dev).index_add_(0, flat, hits)
    return (mask > 0).reshape(h, w)
