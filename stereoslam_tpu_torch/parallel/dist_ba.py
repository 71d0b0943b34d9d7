"""Distributed windowed bundle adjustment: landmark blocks sharded over the
mesh, the Schur reduction summed over the ranks (port of
``stereoslam_tpu/parallel/dist_ba.py``).

The Schur-complement structure factors over landmarks: each rank owns a
slice of the landmark blocks and the observation columns that reference
them, computes its part of ``B``, ``b_c`` and the eliminated terms
``E C^-1 E^T`` / ``E C^-1 b_p``, and one sum over the model axis gives the
reduced 6W x 6W camera system, which every rank solves (42x42 for W=7).
Landmark back-substitution is local.

The schedule is the JAX package's sharded one, not the dense solver's: a
fixed ``rounds x iters`` LM iterations with no early exit, damping from
``damping0`` (1e-4), halved on an accepted step and quadrupled on a
rejected one, capped at 1e3.  With no data-dependent exit the whole solve
makes no host read: the sums are collectives on the device, and the final
orthonormalization goes through ``ops/svd.py`` on float32 CUDA tensors.

Two departures of the port's dense BA (``ops/schur.py``) hold here too:

- the solve runs in float64 and returns the caller's dtype (the rotation
  blocks are projected onto SO(3) after the cast back);
- the damping never falls below ``damping0`` unless ``ops/schur.py``
  ``DAMPING_FLOOR`` is set (JAX's sharded floor: 1e-7).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from stereoslam_tpu_torch.ops import schur, se3
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.ops.schur import (BAProblem, BAResult, _huber_w, _inv3x3,
                                            _project_all, _project_px, _robust_cost,
                                            _sum_by_slot)
from stereoslam_tpu_torch.parallel.distributed import all_reduce
from stereoslam_tpu_torch.parallel.mesh import axis_index, axis_size


def solve_window_ba_sharded(
    prob: BAProblem,
    intr: Intrinsics,
    mesh: DeviceMesh,
    model_axis: str = "model",
    rounds: int = 5,
    iters: int = 10,
    chi2_threshold: float = 5.991,
    huber_delta: float = 5.991,
    damping0: float = 1e-4,
) -> BAResult:
    """Sharded variant of :func:`stereoslam_tpu_torch.ops.schur.solve_window_ba`.

    ``prob`` is the whole problem on every rank, laid out by
    :func:`shard_problem`: rank ``r`` of the model axis owns landmark slots
    ``[r C/n, (r+1) C/n)`` and observation columns ``[r N/n, (r+1) N/n)``,
    whose observations reference only those landmarks.  Cameras are
    replicated.  Per LM iteration the ranks sum the reduced system, its
    right-hand side, ``B`` and the old cost in one collective and the new
    cost in a second.  Returns the whole result on every rank."""
    W, N = prob.obs_valid.shape
    C = prob.lm_pos.shape[0]
    n, rank = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    if C % n or N % n:
        raise ValueError(f"{C} landmark slots and {N} observation columns must split over "
                         f"{n} ranks")
    Cl, Nl = C // n, N // n
    lm_sl, obs_sl = slice(rank * Cl, (rank + 1) * Cl), slice(rank * Nl, (rank + 1) * Nl)
    reduce = partial(all_reduce, mesh=mesh, axis=model_axis)
    out_dt = prob.cam_T.dtype
    dev, dt = prob.lm_pos.device, torch.float64

    cam_T = prob.cam_T.to(dt)
    cam_valid, cam_fixed = prob.cam_valid, prob.cam_fixed
    lm_pos = prob.lm_pos[lm_sl].to(dt)
    lm_valid = prob.lm_valid[lm_sl]
    lm_free = lm_valid & ~prob.lm_fixed[lm_sl]
    obs_px = prob.obs_px[:, obs_sl].to(dt)
    obs_lm = (prob.obs_lm[:, obs_sl] % Cl).long()   # local landmark slots
    base_valid = prob.obs_valid[:, obs_sl] & cam_valid[:, None] & lm_valid[obs_lm]
    moved = cam_valid & ~cam_fixed
    slot_mask = moved.repeat_interleave(6)
    strip_idx = (torch.arange(W, device=dev)[:, None] * Cl + obs_lm).reshape(-1)
    flat_lm = obs_lm.reshape(-1)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eyeS = torch.eye(W * 6, dtype=dt, device=dev)
    lam_min = damping0 if schur.DAMPING_FLOOR is None else schur.DAMPING_FLOOR

    def chi2_of(cam_T, lm_pos):
        r = obs_px - _project_px(cam_T, lm_pos, obs_lm, intr)
        return (r * r).sum(-1)

    def lm_iter(cam_T, lm_pos, inlier, lam):
        px_hat, J_c, J_p = _project_all(cam_T, lm_pos, obs_lm, intr)
        r = obs_px - px_hat
        chi2 = (r * r).sum(-1)
        use = base_valid & inlier
        wgt = torch.where(use, _huber_w(chi2, huber_delta), torch.zeros_like(chi2))
        J_c = torch.where(cam_fixed[:, None, None, None], torch.zeros_like(J_c), J_c)

        B = torch.einsum("wnki,wn,wnkj->wij", J_c, wgt, J_c)
        b_c = torch.einsum("wnki,wn,wnk->wi", J_c, wgt, r)
        JtJ_p = torch.einsum("wnki,wn,wnkj->wnij", J_p, wgt, J_p).reshape(-1, 9)
        Jtr_p = torch.einsum("wnki,wn,wnk->wni", J_p, wgt, r).reshape(-1, 3)
        C_blk = _sum_by_slot(JtJ_p, flat_lm, Cl).reshape(Cl, 3, 3)
        b_p = _sum_by_slot(Jtr_p, flat_lm, Cl)
        JcJp = torch.einsum("wnki,wn,wnkj->wnij", J_c, wgt, J_p).reshape(-1, 18)
        E = _sum_by_slot(JcJp, strip_idx, W * Cl).reshape(W, Cl, 6, 3)

        C_inv = _inv3x3(C_blk + lam * eye3)
        C_inv = torch.where(lm_free[:, None, None], C_inv, torch.zeros_like(C_inv))
        ECi = torch.einsum("wcij,cjk->wcik", E, C_inv)
        S_part = -torch.einsum("wcik,vclk->wivl", ECi, E).reshape(-1)
        rhs_part = (b_c - torch.einsum("wcik,ck->wi", ECi, b_p)).reshape(-1)
        mask = use.to(dt)
        cost_old = (_robust_cost(chi2, huber_delta) * mask).sum()

        # The iteration's first collective: S, rhs, B and the old cost.
        tot = reduce(torch.cat([S_part, rhs_part, B.reshape(-1), cost_old.reshape(1)]))
        S = tot[:W * 36 * W].reshape(W * 6, W * 6)
        rhs = tot[W * 36 * W:W * 36 * W + W * 6]
        B_tot = tot[W * 36 * W + W * 6:-1].reshape(W, 6, 6)
        cost_old = tot[-1]

        S = S + torch.block_diag(*(B_tot + lam * eye6))
        Sm = torch.where(slot_mask[:, None] & slot_mask[None, :], S, torch.zeros_like(S))
        Sm = Sm + torch.diag((~slot_mask).to(dt))
        rhs_m = torch.where(slot_mask, rhs, torch.zeros_like(rhs))
        dx_cam = torch.linalg.solve_ex(Sm + 1e-8 * eyeS, rhs_m)[0].reshape(W, 6)

        Et_dx = torch.einsum("wcij,wi->cj", E, dx_cam)
        dx_p = torch.einsum("cij,cj->ci", C_inv, b_p - Et_dx)
        cam_T_new = torch.where(moved[:, None, None], se3.exp(dx_cam) @ cam_T, cam_T)
        lm_new = torch.where(lm_free[:, None], lm_pos + dx_p, lm_pos)

        # The second: the new cost.
        cost_new = reduce((_robust_cost(chi2_of(cam_T_new, lm_new), huber_delta) * mask)
                          .sum().reshape(1))[0]
        ok = cost_new < cost_old
        cam_T = torch.where(ok, cam_T_new, cam_T)
        lm_pos = torch.where(ok, lm_new, lm_pos)
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=lam_min), torch.clamp(lam * 4.0, max=1e3))
        return cam_T, lm_pos, lam

    inlier = base_valid
    lam = torch.full((), damping0, dtype=dt, device=dev)
    for _ in range(rounds):
        for _ in range(iters):
            cam_T, lm_pos, lam = lm_iter(cam_T, lm_pos, inlier, lam)
        inlier = base_valid & (chi2_of(cam_T, lm_pos) <= chi2_threshold)
    cam_out = cam_T.to(out_dt)
    cam_out = torch.where(moved[:, None, None], se3.orthonormalize(cam_out), cam_out)
    chi2 = chi2_of(cam_out.to(dt), lm_pos)

    # Each rank's landmark rows and observation columns into zeros, summed:
    # the whole result on every rank.
    lm_all = torch.zeros((C, 3), dtype=dt, device=dev)
    lm_all[lm_sl] = lm_pos
    obs_all = torch.zeros((2, W, N), dtype=dt, device=dev)
    obs_all[0, :, obs_sl] = chi2
    obs_all[1, :, obs_sl] = inlier.to(dt)
    tot = reduce(torch.cat([lm_all.reshape(-1), obs_all.reshape(-1)]))
    obs_all = tot[C * 3:].reshape(2, W, N)
    return BAResult(cam_T=cam_out, lm_pos=tot[:C * 3].reshape(C, 3).to(out_dt),
                    obs_inlier=obs_all[1] > 0.5, chi2=obs_all[0].to(out_dt))


def shard_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Re-layout a BAProblem so shard s owns landmark slots ``[s Cl, (s+1) Cl)``
    and the observation columns ``[s Nl, (s+1) Nl)`` that reference them
    (JAX's host relayout, in numpy).  Each observation references one
    landmark, so the layout exists whenever a shard's observations of a
    keyframe fit in ``Nl`` columns; an overflowing observation is dropped."""
    W, N = prob.obs_valid.shape
    C = prob.lm_pos.shape[0]
    Cl, Nl = C // n_shards, N // n_shards
    obs_lm = prob.obs_lm.cpu().numpy()
    obs_valid = prob.obs_valid.cpu().numpy()
    obs_px = prob.obs_px.cpu().numpy()

    new_lm = np.zeros_like(obs_lm)
    new_px = np.zeros_like(obs_px)
    new_valid = np.zeros_like(obs_valid)
    for w in range(W):
        fill = [0] * n_shards
        for i in range(N):
            if not obs_valid[w, i]:
                continue
            s = int(obs_lm[w, i]) // Cl
            if fill[s] >= Nl:
                continue  # the shard's columns are full: drop the observation
            dst = s * Nl + fill[s]
            fill[s] += 1
            new_lm[w, dst] = obs_lm[w, i]
            new_px[w, dst] = obs_px[w, i]
            new_valid[w, dst] = True

    dev = prob.obs_lm.device
    return prob._replace(obs_lm=torch.from_numpy(new_lm).to(dev),
                         obs_px=torch.from_numpy(new_px).to(dev),
                         obs_valid=torch.from_numpy(new_valid).to(dev))
