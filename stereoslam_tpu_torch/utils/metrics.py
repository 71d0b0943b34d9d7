"""Trajectory evaluation: ATE RMSE (with SE3/Sim3 alignment) and RPE.

The reference publishes only qualitative plots (reference README.md:94-96);
these are the standard metrics BASELINE.md targets (ATE RMSE vs reference on
KITTI 00) computed the usual TUM-benchmark way.

Copy of ``stereoslam_tpu/utils/metrics.py`` for the PyTorch port, which
cannot import the JAX package; ``tests/test_torch_copies.py`` holds the two
equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment src -> dst.

    Args: (N, 3) point sets. Returns (R, t, s).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_T_wc: np.ndarray, gt_T_wc: np.ndarray, align: bool = True, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE over matched pose pairs (N, 4, 4)."""
    p_est = est_T_wc[:, :3, 3]
    p_gt = gt_T_wc[:, :3, 3]
    if align:
        R, t, s = align_umeyama(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe(
    est_T_wc: np.ndarray, gt_T_wc: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error (translation RMSE [m], rotation RMSE [rad])."""
    n = len(est_T_wc) - delta
    dt, dr = [], []
    for i in range(n):
        E = (
            np.linalg.inv(np.linalg.inv(gt_T_wc[i]) @ gt_T_wc[i + delta])
            @ (np.linalg.inv(est_T_wc[i]) @ est_T_wc[i + delta])
        )
        dt.append(np.linalg.norm(E[:3, 3]))
        cos = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        dr.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(dt)))), float(np.sqrt(np.mean(np.square(dr))))
