"""Pyramid-expanded ORB descriptors for loop closing (port of
``stereoslam_tpu/ops/orb.py``).

The reference clones each frontend feature to every pyramid level with
``class_id = feature index`` (loopclosing.cpp:94-105), screens each clone for
FAST cornerness and borders at its level (ScreenAndComputeKPsParams,
ORBextractor.cpp:1083-1129), then computes oriented BRIEF per clone
(CalcDescriptors, 1180-1226).  Each level here is one batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.ops.brief import brief_descriptors
from stereoslam_tpu_torch.ops.fast import fast_corner_check_at
from stereoslam_tpu_torch.ops.image import build_pyramid, gaussian_blur
from stereoslam_tpu_torch.ops.orient import ic_angles


class PyramidDescriptors(NamedTuple):
    desc: torch.Tensor   # (M, 8) int32 words of packed BRIEF (uint32 bit patterns)
    xy: torch.Tensor     # (M, 2) level-0 coordinates
    cls: torch.Tensor    # (M,) int32 source feature slot ("class id")
    valid: torch.Tensor  # (M,) bool — survived border + FAST screening


def pyramid_orb(
    img: torch.Tensor, feat_xy: torch.Tensor, feat_valid: torch.Tensor, cfg: SlamConfig
) -> PyramidDescriptors:
    """Descriptors of one keyframe's N features at every level of the 1.2x
    pyramid: ``M = N x n_levels`` rows, level-major, each row's ``xy`` the
    feature's level-0 position and ``cls`` its slot."""
    n_levels, scale = cfg.features.n_levels, cfg.features.scale_factor
    pyr = build_pyramid(img, n_levels, scale)
    N = feat_xy.shape[0]
    descs, valids = [], []
    margin = 20.0
    for lvl in range(n_levels):
        level_img = pyr[lvl]
        xy_l = feat_xy / scale ** lvl
        h, w = level_img.shape
        in_border = ((xy_l[:, 0] >= margin) & (xy_l[:, 0] < w - margin)
                     & (xy_l[:, 1] >= margin) & (xy_l[:, 1] < h - margin))
        is_corner = fast_corner_check_at(level_img, xy_l, float(cfg.features.min_th_fast))
        valids.append(feat_valid & in_border & is_corner)
        descs.append(brief_descriptors(gaussian_blur(level_img), xy_l,
                                       ic_angles(level_img, xy_l)))
    cls = torch.arange(N, dtype=torch.int32, device=img.device)
    return PyramidDescriptors(
        desc=torch.cat(descs),
        xy=feat_xy.repeat(n_levels, 1),
        cls=cls.repeat(n_levels),
        valid=torch.cat(valids),
    )
