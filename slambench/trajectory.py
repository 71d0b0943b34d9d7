"""Keyframe trajectory error against the renderer's ground truth, for the
runs' earlier output lines: a copy of ``stereoslam_tpu_torch/utils/metrics.py``'s
arithmetic (Umeyama alignment, ATE RMSE over camera centres)."""

from __future__ import annotations

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid alignment of (N, 3) ``src`` onto ``dst``: (R, t)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of (N, 3) estimated camera centres against ground truth, after a
    rigid alignment."""
    R, t = align_umeyama(est, gt)
    err = np.linalg.norm((R @ est.T).T + t - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def centres(T_cw: np.ndarray) -> np.ndarray:
    """Camera centres (N, 3) of (N, 4, 4) world-to-camera poses."""
    T_cw = np.asarray(T_cw, np.float64)
    return -np.einsum("nji,nj->ni", T_cw[:, :3, :3], T_cw[:, :3, 3])
