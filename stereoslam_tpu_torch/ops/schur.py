"""Sliding-window bundle adjustment with Schur-complement elimination
(port of ``stereoslam_tpu/ops/schur.py``).

The reference backend's g2o LM over the active map (reference
src/backend.cpp:126-269) as dense masked tensor algebra: observations in a
fixed (W, N) layout, a block-diagonal landmark Hessian with closed-form 3x3
inverses, the reduced 6W x 6W camera system solved densely.  Landmark
reductions sum over the observations' landmark slots with
``index_put_(accumulate=True)``, which on CUDA sorts the slots and adds each
slot's rows in a fixed order (``index_add_`` races atomics), so a run repeats
bit for bit; the JAX package builds one-hot (C, W*N) selection matrices for
the MXU instead.  Same damping schedule (/3 on accept, x10 on reject), exit
rules and masks.

The solve runs in float64 and returns the caller's dtype.  Where a landmark
is seen from nearly one viewpoint its block of C is singular up to the
damping, and S = B - E C^-1 E^T cancels down to the damping along the map's
scale; S's rounding error then becomes a scale step that the cost cannot see
and the accept test cannot refuse.  On the worst BA of the 40-frame
synthetic test sequence the first step changes the window's scale by +0.41%
in float64, +0.10% in the JAX package's jit-compiled float32, but -0.8% with
the same float32 formula run op by op in eager JAX and -8.4% in eager
PyTorch: XLA's fused evaluation rounds less than one rounding per op.  In
float64 the port equals the JAX solve under x64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem: W window slots, N feature slots per
    KF, C landmark slots."""

    cam_T: torch.Tensor      # (W, 4, 4) initial poses (T_cw)
    cam_valid: torch.Tensor  # (W,) bool
    cam_fixed: torch.Tensor  # (W,) bool — pose held constant (gauge anchor)
    lm_pos: torch.Tensor     # (C, 3) compacted landmark positions
    lm_valid: torch.Tensor   # (C,) bool
    lm_fixed: torch.Tensor   # (C,) bool — constraint-only landmarks
    obs_px: torch.Tensor     # (W, N, 2) measurements
    obs_lm: torch.Tensor     # (W, N) int — landmark slot in [0, C)
    obs_valid: torch.Tensor  # (W, N) bool


class BAResult(NamedTuple):
    cam_T: torch.Tensor       # (W, 4, 4) optimized poses
    lm_pos: torch.Tensor      # (C, 3) optimized landmarks
    obs_inlier: torch.Tensor  # (W, N) bool — final chi2-based classification
    chi2: torch.Tensor        # (W, N) final squared reprojection errors


def _camera_points(cam_T, lm_pos, obs_lm):
    R = cam_T[:, None, :3, :3]
    P_c = (R @ lm_pos[obs_lm][..., None])[..., 0] + cam_T[:, None, :3, 3]
    return P_c, R


def _project_px(cam_T, lm_pos, obs_lm, intr: Intrinsics):
    P_c, _ = _camera_points(cam_T, lm_pos, obs_lm)
    Z = P_c[..., 2]
    Z = torch.where(Z.abs() < 1e-6, torch.full_like(Z, 1e-6), Z)
    return torch.stack([intr.fx * P_c[..., 0] / Z + intr.cx, intr.fy * P_c[..., 1] / Z + intr.cy], -1)


def _project_all(cam_T, lm_pos, obs_lm, intr: Intrinsics):
    """Projections px_hat (W,N,2) and Jacobians J_c (W,N,2,6), J_p (W,N,2,3)."""
    P_c, R = _camera_points(cam_T, lm_pos, obs_lm)
    X, Y, Z = P_c[..., 0], P_c[..., 1], P_c[..., 2]
    Z = torch.where(Z.abs() < 1e-6, torch.full_like(Z, 1e-6), Z)
    Zi = 1.0 / Z
    Zi2 = Zi * Zi
    px_hat = torch.stack([intr.fx * X * Zi + intr.cx, intr.fy * Y * Zi + intr.cy], dim=-1)
    zero = torch.zeros_like(Z)
    du = torch.stack([intr.fx * Zi, zero, -intr.fx * X * Zi2], dim=-1)
    dv = torch.stack([zero, intr.fy * Zi, -intr.fy * Y * Zi2], dim=-1)
    dpx_dPc = torch.stack([du, dv], dim=-2)                               # (W, N, 2, 3)
    eye = torch.eye(3, dtype=P_c.dtype, device=P_c.device).expand(P_c.shape[:2] + (3, 3))
    J_c = dpx_dPc @ torch.cat([eye, -se3.hat(P_c)], dim=-1)               # (W, N, 2, 6)
    J_p = dpx_dPc @ R                                                     # (W, N, 2, 3)
    return px_hat, J_c, J_p


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _sum_by_slot(vals: torch.Tensor, slot: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``vals`` summed into ``n`` rows by ``slot``, in a fixed order."""
    return vals.new_zeros((n,) + vals.shape[1:]).index_put_((slot,), vals, accumulate=True)


def _huber_w(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for g2o's RobustKernelHuber with setDelta(delta)."""
    d2 = delta * delta
    return torch.where(chi2 <= d2, torch.ones_like(chi2),
                       torch.sqrt(d2 / torch.clamp(chi2, min=1e-12)))


def _robust_cost(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    d2 = delta * delta
    return torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2)


def solve_window_ba(
    prob: BAProblem,
    intr: Intrinsics,
    rounds: int = 5,
    iters: int = 10,
    chi2_threshold: float = 5.991,
    huber_delta: float = 5.991,
    damping0: float = 1e-3,
) -> BAResult:
    """Windowed BA with the reference's outlier schedule: rounds of LM
    iterations, each round ending with chi2 re-classification, stopping
    once the inlier ratio exceeds 0.5 (backend.cpp:212-232).  Computed in
    float64 (see the module docstring); results come back in the dtype of
    ``prob.cam_T``."""
    out_dt = prob.cam_T.dtype
    prob = prob._replace(cam_T=prob.cam_T.double(), lm_pos=prob.lm_pos.double(),
                         obs_px=prob.obs_px.double())
    W, N = prob.obs_valid.shape
    C = prob.lm_pos.shape[0]
    dev, dt = prob.lm_pos.device, prob.lm_pos.dtype
    obs_lm = prob.obs_lm.long()
    lm_free = prob.lm_valid & ~prob.lm_fixed
    base_valid = prob.obs_valid & prob.cam_valid[:, None] & prob.lm_valid[obs_lm]
    moved = prob.cam_valid & ~prob.cam_fixed
    slot_mask = moved.repeat_interleave(6)
    # Strip E (W, C, 6, 3) is reduced through flat row w * C + slot.
    strip_idx = (torch.arange(W, device=dev)[:, None] * C + obs_lm).reshape(-1)
    flat_lm = obs_lm.reshape(-1)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eyeS = torch.eye(W * 6, dtype=dt, device=dev)

    def chi2_of(cam_T, lm_pos):
        r = prob.obs_px - _project_px(cam_T, lm_pos, obs_lm, intr)
        return (r * r).sum(-1)

    def lm_iter(cam_T, lm_pos, inlier, lam):
        px_hat, J_c, J_p = _project_all(cam_T, lm_pos, obs_lm, intr)
        r = prob.obs_px - px_hat
        chi2 = (r * r).sum(-1)
        wgt = torch.where(base_valid & inlier, _huber_w(chi2, huber_delta), torch.zeros_like(chi2))
        J_c = torch.where(prob.cam_fixed[:, None, None, None], torch.zeros_like(J_c), J_c)

        B = torch.einsum("wnki,wn,wnkj->wij", J_c, wgt, J_c)
        b_c = torch.einsum("wnki,wn,wnk->wi", J_c, wgt, r)
        JtJ_p = torch.einsum("wnki,wn,wnkj->wnij", J_p, wgt, J_p).reshape(-1, 9)
        Jtr_p = torch.einsum("wnki,wn,wnk->wni", J_p, wgt, r).reshape(-1, 3)
        C_blk = _sum_by_slot(JtJ_p, flat_lm, C).reshape(C, 3, 3)
        b_p = _sum_by_slot(Jtr_p, flat_lm, C)
        JcJp = torch.einsum("wnki,wn,wnkj->wnij", J_c, wgt, J_p).reshape(-1, 18)
        E = _sum_by_slot(JcJp, strip_idx, W * C).reshape(W, C, 6, 3)

        C_inv = _inv3x3(C_blk + lam * eye3)
        C_inv = torch.where(lm_free[:, None, None], C_inv, torch.zeros_like(C_inv))

        ECi = torch.einsum("wcij,cjk->wcik", E, C_inv)
        S = -torch.einsum("wcik,vclk->wivl", ECi, E).reshape(W * 6, W * 6)
        S = S + torch.block_diag(*(B + lam * eye6))
        rhs = (b_c - torch.einsum("wcik,ck->wi", ECi, b_p)).reshape(-1)

        Sm = torch.where(slot_mask[:, None] & slot_mask[None, :], S, torch.zeros_like(S))
        Sm = Sm + torch.diag((~slot_mask).to(dt))
        rhs_m = torch.where(slot_mask, rhs, torch.zeros_like(rhs))
        dx_cam = torch.linalg.solve_ex(Sm + 1e-8 * eyeS, rhs_m)[0].reshape(W, 6)

        Et_dx = torch.einsum("wcij,wi->cj", E, dx_cam)
        dx_p = torch.einsum("cij,cj->ci", C_inv, b_p - Et_dx)

        cam_T_new = torch.where(moved[:, None, None], se3.exp(dx_cam) @ cam_T, cam_T)
        lm_new = torch.where(lm_free[:, None], lm_pos + dx_p, lm_pos)

        mask = (base_valid & inlier).to(dt)
        cost_old = (_robust_cost(chi2, huber_delta) * mask).sum()
        cost_new = (_robust_cost(chi2_of(cam_T_new, lm_new), huber_delta) * mask).sum()
        ok = cost_new < cost_old
        cam_T = torch.where(ok, cam_T_new, cam_T)
        lm_pos = torch.where(ok, lm_new, lm_pos)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-8), torch.clamp(lam * 10.0, max=1e3))
        # Exit only on an accepted step with BOTH camera and landmark steps
        # converged (schur.py:244-255).
        dxp = torch.where(lm_free[:, None], dx_p, torch.zeros_like(dx_p))
        done = ok & ((dx_cam * dx_cam).sum() < 1e-10) & ((dxp * dxp).sum() < 1e-8)
        return cam_T, lm_pos, lam, done

    n_base = torch.clamp(base_valid.sum(), min=1).to(torch.float32)
    cam_T, lm_pos, inlier = prob.cam_T, prob.lm_pos, base_valid
    lam = torch.tensor(damping0, dtype=prob.cam_T.dtype, device=dev)
    for _ in range(rounds):
        for _ in range(iters):
            cam_T, lm_pos, lam, done = lm_iter(cam_T, lm_pos, inlier, lam)
            if bool(done):
                break
        inlier = base_valid & (chi2_of(cam_T, lm_pos) <= chi2_threshold)
        if bool(inlier.sum().to(torch.float32) / n_base > 0.5):
            break
    cam_T = torch.where(moved[:, None, None], se3.orthonormalize(cam_T), cam_T)
    return BAResult(cam_T=cam_T.to(out_dt), lm_pos=lm_pos.to(out_dt), obs_inlier=inlier,
                    chi2=chi2_of(cam_T, lm_pos).to(out_dt))
