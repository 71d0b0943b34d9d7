"""Batched RANSAC PnP over P3P and 6-point DLT hypotheses (port of
``stereoslam_tpu/ops/pnp.py``; reference ``cv::solvePnPRansac``,
loopclosing.cpp:264).

Drawing the minimal sets and solving them are two functions here.  The JAX
package draws with ``jax.random.categorical``, which torch cannot reproduce;
:func:`draw_minimal_sets` draws the same kind of sets (with replacement, over
the valid slots) from a ``torch.Generator``, and :func:`pnp_ransac` takes
the index sets, so the two packages can be fed the same sets.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.ops.p3p import p3p_poses


class PnPResult(NamedTuple):
    T_cw: torch.Tensor         # (4, 4) best pose hypothesis
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor           # () bool — a usable hypothesis was found
    best: torch.Tensor         # () int64 — index of the winning hypothesis


MIN_SET = 6  # DLT needs >= 6 points


def draw_minimal_sets(valid: torch.Tensor, generator: torch.Generator,
                      iterations: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iterations, 3) P3P sets and (max(iterations // 2, 1), 6) DLT sets of
    slot indices, drawn with replacement uniformly over the valid slots (over
    all slots when none is valid), on ``valid``'s device without a host read."""
    n_dlt = max(iterations // 2, 1)
    w = torch.where(valid.any(), valid.to(torch.float32), torch.ones_like(valid, dtype=torch.float32))
    sets3 = torch.multinomial(w, iterations * 3, replacement=True, generator=generator)
    sets6 = torch.multinomial(w, n_dlt * MIN_SET, replacement=True, generator=generator)
    return sets3.reshape(iterations, 3), sets6.reshape(n_dlt, MIN_SET)


def _normalize(px: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    return torch.stack([(px[..., 0] - intr.cx) / intr.fx, (px[..., 1] - intr.cy) / intr.fy], -1)


def _dlt_pose(X: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    """Direct linear transform for minimal sets X (..., S, 3), pn (..., S, 2)
    -> (..., 4, 4) T_cw with the rotation projected onto SO(3)."""
    S = X.shape[-2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)         # (..., S, 4)
    zeros = torch.zeros_like(Xh)
    # Rows [X 0 -x*X ; 0 X -y*X] for P = [R|t], p = P Xh.
    r1 = torch.cat([Xh, zeros, -pn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -pn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                  # (..., 2S, 12)
    AtA = A.transpose(-1, -2) @ A
    # eigh raises on non-finite input; such sets lose the scoring anyway.
    AtA = torch.where(torch.isfinite(AtA).all(-1).all(-1)[..., None, None], AtA,
                      torch.zeros_like(AtA))
    _, vecs = torch.linalg.eigh(AtA)
    P = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))            # null direction
    R_raw = P[..., :3]
    u, s, vt = torch.linalg.svd(R_raw)
    scale = s.mean(-1)
    det = torch.linalg.det(u @ vt)
    neg = (det < 0)[..., None, None]
    R = torch.where(neg, -(u @ vt), u @ vt)
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12),
                                scale)[..., None]
    t = torch.where(neg[..., 0], -t, t)
    # Cheirality: the majority of the set must lie in front.
    z = (X @ R.transpose(-1, -2))[..., 2] + t[..., None, 2]
    flip = (z < 0).to(torch.int32).sum(-1) > S // 2
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # Re-project onto SO(3) after any flip.
    u2, _, vt2 = torch.linalg.svd(R)
    det2 = torch.linalg.det(u2 @ vt2)
    u2 = torch.cat([u2[..., :, :2], u2[..., :, 2:] * torch.sign(det2)[..., None, None]], dim=-1)
    return se3.from_Rt(u2 @ vt2, t)


def pnp_ransac(
    X_w: torch.Tensor,
    obs_px: torch.Tensor,
    valid: torch.Tensor,
    intr: Intrinsics,
    sets3: torch.Tensor,
    sets6: torch.Tensor,
    chi2_threshold: float = 5.991,
    min_inliers: int = 6,
) -> PnPResult:
    """RANSAC over every P3P candidate of ``sets3`` (K3, 3) (up to 4 each)
    followed by the DLT pose of each ``sets6`` (K6, 6) set, all scored against
    every point; the first best-scoring hypothesis wins."""
    nvalid = valid.to(torch.int32).sum()
    T_dlt = _dlt_pose(X_w[sets6], _normalize(obs_px[sets6], intr))     # (K6, 4, 4)
    T_p3p, ok3 = p3p_poses(X_w[sets3], _normalize(obs_px[sets3], intr))  # (K3, 4, 4, 4)
    T_p3p, ok3 = T_p3p.reshape(-1, 4, 4), ok3.reshape(-1)
    # A failed P3P branch becomes a pose with every point far behind the
    # camera (z = -1e9): zero inliers, where an identity could score.
    far = torch.eye(4, dtype=T_p3p.dtype, device=T_p3p.device)
    far[2, 3] = -1e9
    T_p3p = torch.where(ok3[:, None, None], T_p3p, far)
    T_hyps = torch.cat([T_p3p, T_dlt])

    P_c = torch.einsum("kij,nj->kni", T_hyps[:, :3, :3], X_w) + T_hyps[:, None, :3, 3]
    z = P_c[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = intr.fx * P_c[..., 0] / z_safe + intr.cx
    v = intr.fy * P_c[..., 1] / z_safe + intr.cy
    r = torch.stack([u, v], dim=-1) - obs_px[None]
    chi2 = (r * r).sum(-1)
    inl = (chi2 <= chi2_threshold) & (z > 0) & valid[None]
    scores = inl.to(torch.int32).sum(1)
    best = torch.argmax(scores)
    ok = (scores[best] >= min_inliers) & (nvalid >= MIN_SET)
    return PnPResult(T_cw=T_hyps[best], inliers=inl[best], num_inliers=scores[best], ok=ok,
                     best=best)
