"""Image pyramids: a frozen copy of ``stereoslam_tpu_torch/ops/image.py``'s LK
pyramid, part of the benchmark's plain reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
