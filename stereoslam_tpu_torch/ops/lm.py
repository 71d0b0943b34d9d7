"""Masked Levenberg-Marquardt for pose-only reprojection optimization
(port of ``stereoslam_tpu/ops/lm.py``).

One SE(3) vertex, N unary reprojection edges with Huber kernels, and the
reference's 4-rounds-of-10-iterations chi^2 outlier schedule
(reference src/frontend.cpp:176-276, Jacobians of g2o_types.h:63-102),
with masking instead of edge removal.  ``T_cw`` maps world -> camera and the
Jacobian is w.r.t. the left-multiplicative update ``exp(dx) @ T_cw``.

The early exits of the JAX while-loops become host reads of one scalar.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor         # (4, 4) optimized pose
    inlier: torch.Tensor       # (N,) bool — final inlier classification
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor         # (N,) final squared reprojection error (pixels^2)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


def project_only(T_cw: torch.Tensor, X_w: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Projection without Jacobians (cost evaluation)."""
    P = se3.act(T_cw, X_w)
    Z = _safe_z(P[..., 2])
    return torch.stack([intr.fx * P[..., 0] / Z + intr.cx, intr.fy * P[..., 1] / Z + intr.cy], -1)


def project_jacobian(
    T_cw: torch.Tensor, X_w: torch.Tensor, intr: Intrinsics
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection + analytic 2x6 Jacobian w.r.t. the left-mul twist [v, w]
    (EdgeProjectionPoseOnly::linearizeOplus, g2o_types.h:80-99).

    Returns (px (..., 2), J (..., 2, 6)).
    """
    P = se3.act(T_cw, X_w)
    X, Y = P[..., 0], P[..., 1]
    Zinv = 1.0 / _safe_z(P[..., 2])
    Zinv2 = Zinv * Zinv
    px = torch.stack([intr.fx * X * Zinv + intr.cx, intr.fy * Y * Zinv + intr.cy], dim=-1)
    zero = torch.zeros_like(X)
    du = torch.stack([intr.fx * Zinv, zero, -intr.fx * X * Zinv2], dim=-1)
    dv = torch.stack([zero, intr.fy * Zinv, -intr.fy * Y * Zinv2], dim=-1)
    dpx_dP = torch.stack([du, dv], dim=-2)                             # (..., 2, 3)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(P.shape[:-1] + (3, 3))
    dP_dxi = torch.cat([eye, -se3.hat(P)], dim=-1)                      # (..., 3, 6)
    return px, dpx_dP @ dP_dxi


def _huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of g2o's RobustKernelHuber(sqrt(delta2)) (frontend.cpp:207)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def solve6(H: torch.Tensor, b: torch.Tensor, damping: torch.Tensor) -> torch.Tensor:
    """Damped 6x6 normal equations by Cholesky.  A failed factorization
    yields NaN, which the caller's cost gate rejects — the behaviour of
    ``jnp.linalg.cholesky``, without a host-syncing error check."""
    A = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def optimize_pose(
    T_cw0: torch.Tensor,
    X_w: torch.Tensor,
    obs_px: torch.Tensor,
    valid: torch.Tensor,
    intr: Intrinsics,
    rounds: int = 4,
    iters: int = 10,
    chi2_threshold: float = 5.991,
    damping0: float = 1e-3,
) -> PoseOptResult:
    """Pose-only robust LM with the reference's outlier schedule
    (frontend.cpp:213-247): after each round observations with
    chi2 > threshold are excluded from the next (and may return); Huber
    weighting only in rounds 0-1; accept a step iff the robust cost drops
    (damping x0.5 on accept, x4 on reject); stop a round early only on an
    accepted, converged step; orthonormalize the result.
    """
    delta2 = chi2_threshold
    T = T_cw0
    inlier = valid
    lam = torch.tensor(damping0, dtype=T_cw0.dtype, device=T_cw0.device)

    def robust_cost(chi2, mask):
        return (torch.minimum(chi2, delta2 + torch.sqrt(delta2 * chi2)) * mask).sum()

    for rnd in range(rounds):
        use_huber = rnd < 2
        for _ in range(iters):
            px, J = project_jacobian(T, X_w, intr)
            r = obs_px - px
            chi2 = (r * r).sum(-1)
            w = _huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
            w = torch.where(valid & inlier, w, torch.zeros_like(w))
            Hn = torch.einsum("nki,n,nkj->ij", J, w, J)
            bn = torch.einsum("nki,n,nk->i", J, w, r)
            dx = solve6(Hn, bn, lam)
            T_new = se3.left_update(T, dx)
            r2 = obs_px - project_only(T_new, X_w, intr)
            chi2_new = (r2 * r2).sum(-1)
            mask = (valid & inlier).to(chi2.dtype)
            improved = robust_cost(chi2_new, mask) < robust_cost(chi2, mask)
            T = torch.where(improved, T_new, T)
            lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-6),
                              torch.clamp(lam * 4.0, max=1e2))
            if bool(improved & ((dx * dx).sum() < 1e-12)):
                break
        r = obs_px - project_only(T, X_w, intr)
        inlier = valid & ((r * r).sum(-1) <= delta2)

    T = se3.orthonormalize(T)
    r = obs_px - project_only(T, X_w, intr)
    return PoseOptResult(
        T_cw=T,
        inlier=inlier,
        num_inliers=inlier.sum().to(torch.int32),
        chi2=(r * r).sum(-1),
    )
