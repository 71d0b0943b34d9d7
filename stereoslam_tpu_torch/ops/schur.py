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
the MXU instead.  Same damping schedule (/3 on accept, x10 on reject) but for
its floor (below), exit rules and masks.

**Exit tests: two loops over one step.**  The JAX package's two
``while_loop``s (a round's LM iterations until a converged step, the rounds
until the inlier ratio passes) become one step function, ``_lm_step``, a
round's end, ``_classify``, and two loops over them that give the same result bit
for bit.  ``_early_exit`` reads each exit test on the host and stops at the
rule: the eager solve on CPU tensors (where a read is free) or where the
caller asks (``host_exit=True``), and ``core/graphs.py`` ``SteppedBA``, which
replays a one-step graph (``_step_in_place``) and a round-end graph
(``_end_round_in_place``) from the host, for callers that wait for the
result (the inline BA, the fleet's keyframe service).  ``_fixed_steps``
reads nothing back: every ``rounds x iters`` step runs and the carry
(poses, landmarks, damping, inliers) is frozen by ``torch.where`` on two
device flags, the round's ``done`` and the solve's ``stop``, so the whole
solve is one CUDA graph (``core/graphs.py`` ``BAGraph``) that the
asynchronous BA replays on a side stream; its frozen steps still compute,
since PyTorch 2.11, the card's, cannot capture a step into a conditional
graph node (no ``CUDAGraph.begin_capture_to_if_node``).  On CUDA tensors
:func:`solve_window_ba` takes the fixed steps unless the caller asks for
the host's exit.

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

The damping never falls below its starting value ``damping0`` (the JAX
package lets it fall to 1e-8).  While the window holds the first keyframe and
no landmark is fixed, only that keyframe anchors the gauge and the scale is
observed by little more than noise; a float32 solve cannot resolve curvature
that small, but a float64 one with the damping at 1e-8 follows it.  On the
world circuit's third keyframe (frame 13 of ``run_world_eval``'s sequence)
the JAX package's float32 BA keeps the window's scale within 3%, while the
float64 solve, the port's and JAX's under x64 alike, shrinks it by 47% (KF 2
from 10.66 m to 5.62 m along the road, ground truth 10.4 m); with the damping
held at 1e-3 it moves 5% (10.13 m).  ``tests/test_torch_eval_world.py`` holds
that window to the JAX package's float32 result.  This departs from the
reference's algorithm; ``scripts/ba_damping_seeds.py`` sets ``DAMPING_FLOOR``
to the JAX package's 1e-8 to compare the two floors over seeds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics

# The damping's floor; None holds it at ``damping0`` (see the module docstring).
DAMPING_FLOOR = None
# The damping a solve starts from.
DAMPING0 = 1e-3


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


class _Carry(NamedTuple):
    """What the LM loop changes: a step the poses, landmarks and damping, a
    round's end the inliers."""

    cam_T: torch.Tensor   # (W, 4, 4) float64
    lm_pos: torch.Tensor  # (C, 3) float64
    lam: torch.Tensor     # () float64 damping
    inlier: torch.Tensor  # (W, N) bool


def _start(prob: BAProblem, intr: Intrinsics, huber_delta: float, damping0: float):
    """A solve's float64 window, the count of its base observations and its
    first carry: (win, n_base, carry).  The carry shares the window's
    tensors."""
    prob = prob._replace(cam_T=prob.cam_T.double(), lm_pos=prob.lm_pos.double(),
                         obs_px=prob.obs_px.double())
    lam_min = damping0 if DAMPING_FLOOR is None else DAMPING_FLOOR
    win = _window(prob, intr, huber_delta, lam_min)
    n_base = torch.clamp(win.base_valid.sum(), min=1).to(torch.float32)
    lam = torch.full((), damping0, dtype=prob.cam_T.dtype, device=prob.cam_T.device)
    return win, n_base, _Carry(prob.cam_T, prob.lm_pos, lam, win.base_valid)


def _step_in_place(win: _Window, carry: _Carry) -> torch.Tensor:
    """One LM step written into ``carry``; returns its ``done`` flag on the
    device."""
    cam_T, lm_pos, lam, done = _lm_step(win, carry.cam_T, carry.lm_pos, carry.inlier, carry.lam)
    carry.cam_T.copy_(cam_T)
    carry.lm_pos.copy_(lm_pos)
    carry.lam.copy_(lam)
    return done


def _end_round_in_place(win: _Window, carry: _Carry, n_base, chi2_threshold: float
                        ) -> torch.Tensor:
    """A round's end written into ``carry``; returns its ratio test on the
    device."""
    inlier, stop = _classify(win, carry.cam_T, carry.lm_pos, n_base, chi2_threshold)
    carry.inlier.copy_(inlier)
    return stop


def _early_exit(step: Callable[[], bool], end_round: Callable[[], bool], rounds: int,
                iters: int) -> int:
    """The rounds with the host reading each exit test: ``step()`` runs one
    LM step and returns whether it converged, ``end_round()`` ends a round
    and returns whether its ratio test passed.  A round ends at its first
    converged step, the solve at the first round whose ratio test passes.
    Returns the number of steps run."""
    steps = 0
    for _ in range(rounds):
        for _ in range(iters):
            steps += 1
            if step():
                break
        if end_round():
            break
    return steps


def _fixed_steps(win, cam_T, lm_pos, inlier, lam, n_base, rounds, iters, chi2_threshold):
    """All ``rounds x iters`` steps, the carry frozen by two device flags:
    ``done`` (the round's converged step) and ``stop`` (a passed ratio
    test).  The two ``while_loop``s' result with no host read."""
    stop = torch.zeros((), dtype=torch.bool, device=cam_T.device)
    for _ in range(rounds):
        done = stop
        for _ in range(iters):
            cam_T2, lm_pos2, lam2, converged = _lm_step(win, cam_T, lm_pos, inlier, lam)
            cam_T = torch.where(done, cam_T, cam_T2)
            lm_pos = torch.where(done, lm_pos, lm_pos2)
            lam = torch.where(done, lam, lam2)
            done = done | converged
        inlier2, passed = _classify(win, cam_T, lm_pos, n_base, chi2_threshold)
        inlier = torch.where(stop, inlier, inlier2)
        stop = stop | passed
    return cam_T, lm_pos, inlier


def _finish(win: _Window, cam_T, lm_pos, inlier, out_dt: torch.dtype) -> BAResult:
    """The solve's result from its last carry, in ``out_dt``."""
    cam_T = torch.where(win.moved[:, None, None], se3.orthonormalize(cam_T), cam_T)
    return BAResult(cam_T=cam_T.to(out_dt), lm_pos=lm_pos.to(out_dt), obs_inlier=inlier,
                    chi2=_chi2(win, cam_T, lm_pos).to(out_dt))


def solve_window_ba(
    prob: BAProblem,
    intr: Intrinsics,
    rounds: int = 5,
    iters: int = 10,
    chi2_threshold: float = 5.991,
    huber_delta: float = 5.991,
    damping0: float = DAMPING0,
    host_exit: Optional[bool] = None,
) -> BAResult:
    """Windowed BA with the reference's outlier schedule: rounds of LM
    iterations, each round ending with chi2 re-classification, stopping
    once the inlier ratio exceeds 0.5 (backend.cpp:212-232).  Computed in
    float64 (see the module docstring); results come back in the dtype of
    ``prob.cam_T``.

    ``host_exit``: end a round at its converged step and the solve at its
    passed ratio test by reading them on the host (default: on CPU tensors
    only).  Otherwise every ``rounds x iters`` step runs with the carry
    frozen on the device, which reads nothing back, so the solve can be
    captured in a CUDA graph; the result is the same bit for bit."""
    out_dt = prob.cam_T.dtype
    win, n_base, carry = _start(prob, intr, huber_delta, damping0)
    if host_exit is None:
        host_exit = prob.cam_T.device.type == "cpu"
    if host_exit:
        carry = _Carry(*(t.clone() for t in carry))
        _early_exit(lambda: bool(_step_in_place(win, carry)),
                    lambda: bool(_end_round_in_place(win, carry, n_base, chi2_threshold)),
                    rounds, iters)
        cam_T, lm_pos, inlier = carry.cam_T, carry.lm_pos, carry.inlier
    else:
        cam_T, lm_pos, inlier = _fixed_steps(win, carry.cam_T, carry.lm_pos, carry.inlier,
                                             carry.lam, n_base, rounds, iters, chi2_threshold)
    return _finish(win, cam_T, lm_pos, inlier, out_dt)
