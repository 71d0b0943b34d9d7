"""SE(3) on torch tensors: a frozen copy of ``stereoslam_tpu_torch/ops/se3.py``,
part of the benchmark's plain reference.  ``orthonormalize`` calls
``torch.linalg.svd``, whose arithmetic the port's cuSOLVER binding
reproduces without a host read.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), Taylor-guarded near 0."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye(3, w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation logarithm, (..., 3, 3) -> (..., 3): Taylor near identity,
    generic atan2 form, and the axis-from-(R + I) form near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - R.transpose(-1, -2))
    sin_theta = 0.5 * torch.sqrt(torch.clamp((antisym * antisym).sum(-1), min=1e-24))
    theta = torch.atan2(sin_theta, cos_theta)

    small = sin_theta < 1e-5
    sin_safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    w_generic = scale[..., None] * antisym

    B = R + _eye(3, R)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(torch.clamp(diag, min=0.0), dim=-1)
    idx = k[..., None, None].expand(*B.shape[:-1], 1)
    col = torch.gather(B, -1, idx)[..., 0]
    norm = torch.linalg.norm(col, dim=-1, keepdim=True)
    w_pi = col / torch.clamp(norm, min=_EPS) * theta[..., None]

    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
    )
    W = hat(w)
    return _eye(3, w) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = theta * 0.5
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / theta2_safe,
    )
    W = hat(w)
    return _eye(3, w) - 0.5 * W + cot[..., None, None] * (W @ W)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) twist [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return from_Rt(so3_exp(w), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> (..., 6) twist [v, w]."""
    w = so3_log(T[..., :3, :3])
    v = (_so3_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3).
    Out of place, so ``torch.func`` transforms can differentiate through it."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]), torch.ones_like(top[..., :1, :1])], -1)
    return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4)).clone()


def inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) to point(s): (..., 4, 4) x (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def left_update(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``exp(xi) @ T`` (the reference's pose-vertex update, g2o_types.h:36-41)."""
    return exp(xi) @ T


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(T[..., :3, :3])
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[..., None, None]], dim=-1)
    return from_Rt(u @ vt, T[..., :3, 3])
