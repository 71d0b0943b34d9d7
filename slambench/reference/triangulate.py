"""Linear (DLT) stereo triangulation: a frozen copy of
``stereoslam_tpu_torch/ops/triangulate.py``, part of the benchmark's plain
reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slambench.reference import se3
from slambench.reference.camera import Intrinsics, pixel2camera


def triangulate_pair(
    T_cw_a: torch.Tensor,
    T_cw_b: torch.Tensor,
    pn_a: torch.Tensor,
    pn_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points from two views of normalized rays (z = 1).

    Returns (points_w (..., 3), good (...,) bool) — good is False for
    degenerate geometry (parallel rays, or a multi-dimensional null space).
    """
    P_a = T_cw_a[..., :3, :]
    P_b = T_cw_b[..., :3, :]

    def _rows(P, pn):
        return (pn[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                pn[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    a1, a2 = _rows(P_a, pn_a)
    b1, b2 = _rows(P_b, pn_b)
    A = torch.stack(torch.broadcast_tensors(a1, a2, b1, b2), dim=-2)  # (..., 4, 4)
    eigvals, eigvecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)  # ascending
    h = eigvecs[..., :, 0]
    w = h[..., 3]
    w_safe = torch.where(w.abs() < 1e-10, torch.full_like(w, 1e-10), w)
    p = h[..., :3] / w_safe[..., None]

    # Degeneracy gate (algorithm.h:27-30, plus a non-tiny second singular value).
    s0 = torch.sqrt(torch.clamp(eigvals[..., 0], min=0.0))
    s1 = torch.sqrt(torch.clamp(eigvals[..., 1], min=1e-20))
    s3 = torch.sqrt(torch.clamp(eigvals[..., 3], min=1e-20))
    good = ((s0 / s1) < 1e-2) & (s1 > 1e-5 * s3)
    return p, good


def triangulate_stereo(
    px_left: torch.Tensor,
    px_right: torch.Tensor,
    T_cw_left: torch.Tensor,
    T_cw_right: torch.Tensor,
    intr_left: Intrinsics,
    intr_right: Intrinsics,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels of a stereo pair -> world points + validity (which also needs
    positive depth in the left camera, reference frontend.cpp:472)."""
    p_w, good = triangulate_pair(
        T_cw_left, T_cw_right, pixel2camera(px_left, intr_left), pixel2camera(px_right, intr_right)
    )
    z = se3.act(T_cw_left, p_w)[..., 2]
    return p_w, good & (z > 0.0)
