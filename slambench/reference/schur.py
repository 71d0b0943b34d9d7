"""Windowed Schur-complement BA: a frozen copy of
``stereoslam_tpu_torch/ops/schur.py``, part of the benchmark's plain
reference.  The solve runs in ``solve_dtype``: float64 as the port states it
(the reference), float32 for the benchmark's control, the precision below.
The reference runs the host-read early exit; the port's fixed-step driver
gives the same result bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference import se3
from slambench.reference.camera import Intrinsics

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


class _Window(NamedTuple):
    """What every LM step of one solve shares: the float64 problem, its
    masks, its index maps and its constants."""

    prob: BAProblem          # float64 poses, landmarks and measurements
    intr: Intrinsics
    obs_lm: torch.Tensor     # (W, N) long
    base_valid: torch.Tensor  # (W, N) observations that take part at all
    lm_free: torch.Tensor    # (C,) landmarks the solve moves
    moved: torch.Tensor      # (W,) cameras the solve moves
    slot_mask: torch.Tensor  # (6W,) rows of the reduced system that move
    strip_idx: torch.Tensor  # (W*N,) row w * C + slot of the strip E
    flat_lm: torch.Tensor    # (W*N,) landmark slot of each observation
    eye3: torch.Tensor
    eye6: torch.Tensor
    eyeS: torch.Tensor
    huber_delta: float
    lam_min: float


def _window(prob: BAProblem, intr: Intrinsics, huber_delta: float, lam_min: float) -> _Window:
    W, N = prob.obs_valid.shape
    C = prob.lm_pos.shape[0]
    dev, dt = prob.lm_pos.device, prob.lm_pos.dtype
    obs_lm = prob.obs_lm.long()
    moved = prob.cam_valid & ~prob.cam_fixed
    return _Window(
        prob=prob, intr=intr, obs_lm=obs_lm,
        base_valid=prob.obs_valid & prob.cam_valid[:, None] & prob.lm_valid[obs_lm],
        lm_free=prob.lm_valid & ~prob.lm_fixed,
        moved=moved,
        slot_mask=moved.repeat_interleave(6),
        strip_idx=(torch.arange(W, device=dev)[:, None] * C + obs_lm).reshape(-1),
        flat_lm=obs_lm.reshape(-1),
        eye3=torch.eye(3, dtype=dt, device=dev),
        eye6=torch.eye(6, dtype=dt, device=dev),
        eyeS=torch.eye(W * 6, dtype=dt, device=dev),
        huber_delta=huber_delta, lam_min=lam_min)


def _chi2(win: _Window, cam_T: torch.Tensor, lm_pos: torch.Tensor) -> torch.Tensor:
    r = win.prob.obs_px - _project_px(cam_T, lm_pos, win.obs_lm, win.intr)
    return (r * r).sum(-1)


def _lm_step(win: _Window, cam_T, lm_pos, inlier, lam):
    """One damped Gauss-Newton step of the window (the body of the JAX
    package's inner ``while_loop``): the step taken if it lowers the robust
    cost, the damping moved, and whether the step converged.  Returns
    (cam_T, lm_pos, lam, done); reads nothing back."""
    prob, dt = win.prob, lm_pos.dtype
    W, C = cam_T.shape[0], lm_pos.shape[0]
    px_hat, J_c, J_p = _project_all(cam_T, lm_pos, win.obs_lm, win.intr)
    r = prob.obs_px - px_hat
    chi2 = (r * r).sum(-1)
    wgt = torch.where(win.base_valid & inlier, _huber_w(chi2, win.huber_delta),
                      torch.zeros_like(chi2))
    J_c = torch.where(prob.cam_fixed[:, None, None, None], torch.zeros_like(J_c), J_c)

    B = torch.einsum("wnki,wn,wnkj->wij", J_c, wgt, J_c)
    b_c = torch.einsum("wnki,wn,wnk->wi", J_c, wgt, r)
    JtJ_p = torch.einsum("wnki,wn,wnkj->wnij", J_p, wgt, J_p).reshape(-1, 9)
    Jtr_p = torch.einsum("wnki,wn,wnk->wni", J_p, wgt, r).reshape(-1, 3)
    C_blk = _sum_by_slot(JtJ_p, win.flat_lm, C).reshape(C, 3, 3)
    b_p = _sum_by_slot(Jtr_p, win.flat_lm, C)
    JcJp = torch.einsum("wnki,wn,wnkj->wnij", J_c, wgt, J_p).reshape(-1, 18)
    E = _sum_by_slot(JcJp, win.strip_idx, W * C).reshape(W, C, 6, 3)

    C_inv = _inv3x3(C_blk + lam * win.eye3)
    C_inv = torch.where(win.lm_free[:, None, None], C_inv, torch.zeros_like(C_inv))

    ECi = torch.einsum("wcij,cjk->wcik", E, C_inv)
    S = -torch.einsum("wcik,vclk->wivl", ECi, E).reshape(W * 6, W * 6)
    S = S + torch.block_diag(*(B + lam * win.eye6))
    rhs = (b_c - torch.einsum("wcik,ck->wi", ECi, b_p)).reshape(-1)

    slot_mask = win.slot_mask
    Sm = torch.where(slot_mask[:, None] & slot_mask[None, :], S, torch.zeros_like(S))
    Sm = Sm + torch.diag((~slot_mask).to(dt))
    rhs_m = torch.where(slot_mask, rhs, torch.zeros_like(rhs))
    dx_cam = torch.linalg.solve_ex(Sm + 1e-8 * win.eyeS, rhs_m)[0].reshape(W, 6)

    Et_dx = torch.einsum("wcij,wi->cj", E, dx_cam)
    dx_p = torch.einsum("cij,cj->ci", C_inv, b_p - Et_dx)

    cam_T_new = torch.where(win.moved[:, None, None], se3.exp(dx_cam) @ cam_T, cam_T)
    lm_new = torch.where(win.lm_free[:, None], lm_pos + dx_p, lm_pos)

    mask = (win.base_valid & inlier).to(dt)
    cost_old = (_robust_cost(chi2, win.huber_delta) * mask).sum()
    cost_new = (_robust_cost(_chi2(win, cam_T_new, lm_new), win.huber_delta) * mask).sum()
    ok = cost_new < cost_old
    cam_T = torch.where(ok, cam_T_new, cam_T)
    lm_pos = torch.where(ok, lm_new, lm_pos)
    lam = torch.where(ok, torch.clamp(lam / 3.0, min=win.lam_min),
                      torch.clamp(lam * 10.0, max=1e3))
    # Exit only on an accepted step with BOTH camera and landmark steps
    # converged (schur.py:244-255).
    dxp = torch.where(win.lm_free[:, None], dx_p, torch.zeros_like(dx_p))
    done = ok & ((dx_cam * dx_cam).sum() < 1e-10) & ((dxp * dxp).sum() < 1e-8)
    return cam_T, lm_pos, lam, done


def _classify(win: _Window, cam_T, lm_pos, n_base, chi2_threshold: float):
    """A round's end: the chi2 inliers, and whether their share of the
    base observations ends the solve (> 0.5, backend.cpp:212-232)."""
    inlier = win.base_valid & (_chi2(win, cam_T, lm_pos) <= chi2_threshold)
    return inlier, inlier.sum().to(torch.float32) / n_base > 0.5


def _early_exit(win, cam_T, lm_pos, inlier, lam, n_base, rounds, iters, chi2_threshold):
    """The rounds with the host reading each exit test: a round ends at the
    first converged step, the solve at the first round whose ratio test
    passes."""
    for _ in range(rounds):
        for _ in range(iters):
            cam_T, lm_pos, lam, done = _lm_step(win, cam_T, lm_pos, inlier, lam)
            if bool(done):
                break
        inlier, stop = _classify(win, cam_T, lm_pos, n_base, chi2_threshold)
        if bool(stop):
            break
    return cam_T, lm_pos, inlier


def solve_window_ba(
    prob: BAProblem,
    intr: Intrinsics,
    rounds: int = 5,
    iters: int = 10,
    chi2_threshold: float = 5.991,
    huber_delta: float = 5.991,
    damping0: float = 1e-3,
    solve_dtype: torch.dtype = torch.float64,
) -> BAResult:
    """Windowed BA with the reference's outlier schedule: rounds of LM
    iterations, each round ending with chi2 re-classification, stopping
    once the inlier ratio exceeds 0.5 (backend.cpp:212-232), the host
    reading each exit test.  Computed in ``solve_dtype``; results come back
    in the dtype of ``prob.cam_T``."""
    out_dt = prob.cam_T.dtype
    prob = prob._replace(cam_T=prob.cam_T.to(solve_dtype), lm_pos=prob.lm_pos.to(solve_dtype),
                         obs_px=prob.obs_px.to(solve_dtype))
    lam_min = damping0
    win = _window(prob, intr, huber_delta, lam_min)
    n_base = torch.clamp(win.base_valid.sum(), min=1).to(torch.float32)
    lam = torch.full((), damping0, dtype=prob.cam_T.dtype, device=prob.cam_T.device)
    cam_T, lm_pos, inlier = _early_exit(win, prob.cam_T, prob.lm_pos, win.base_valid, lam, n_base,
                                  rounds, iters, chi2_threshold)
    cam_T = torch.where(win.moved[:, None, None], se3.orthonormalize(cam_T), cam_T)
    return BAResult(cam_T=cam_T.to(out_dt), lm_pos=lm_pos.to(out_dt), obs_inlier=inlier,
                    chi2=_chi2(win, cam_T, lm_pos).to(out_dt))
