"""Batched P3P minimal solver (Grunert) with a closed-form quartic (port of
``stereoslam_tpu/ops/p3p.py``).

Grunert's elimination reduces P3P to a quartic in the depth ratio
``v = s3/s1`` (coefficients from a sympy resultant of the two depth
quadrics); the quartic is solved in closed form (two quadratics via the
resolvent cubic), every root is re-validated against the quartic, and
depths -> camera points -> 3-point Procrustes give up to 4 poses per sample.
The world triangle is rescaled to unit RMS side so float32 suffices.

Every function broadcasts over leading batch dimensions, where the JAX
package ``vmap``s a per-sample function.  ``torch.linalg.svd`` raises on
non-finite input, so depths of degenerate samples (a point drawn twice) are
zeroed before the Procrustes step; those candidates are already invalid.
"""

from __future__ import annotations

import torch

from stereoslam_tpu_torch.ops import se3

_EPS = 1e-12


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_max_real_root(c2, c1, c0):
    """Largest real root of z^3 + c2 z^2 + c1 z + c0, element-wise."""
    p = c1 - c2 * c2 / 3.0
    q = 2.0 * c2 ** 3 / 27.0 - c2 * c1 / 3.0 + c0
    shift = -c2 / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # One real root (disc > 0): Cardano.
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_one = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    # Three real roots: trigonometric form; the largest is k = 0.
    m = torch.sqrt(torch.clamp(-p / 3.0, min=_EPS))
    den = 2.0 * p * m + torch.where(p == 0, torch.full_like(p, _EPS), torch.zeros_like(p))
    cosarg = torch.clamp(3.0 * q / den, -1.0, 1.0)
    t_three = 2.0 * m * torch.cos(torch.arccos(cosarg) / 3.0)
    return torch.where(disc > 0, t_one, t_three) + shift


def quartic_real_roots(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0, element-wise.

    Returns (roots (..., 4), valid (..., 4) bool): a root is valid when its
    quadratic factor's discriminant is non-negative and it passes the
    scale-normalized residual check.
    """
    c4s = torch.where(torch.abs(c4) < _EPS, torch.sign(c4) * _EPS + _EPS, c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # Depress: x = y - a/4 -> y^4 + p y^2 + q y + r.
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # (y^2 + al y + be)(y^2 - al y + ga) with al^2 the resolvent's largest root.
    z0 = torch.clamp(_cubic_max_real_root(2.0 * p, p * p - 4.0 * r, -q * q), min=0.0)
    al = torch.sqrt(z0)
    small = al < 1e-10
    al_s = torch.where(small, torch.ones_like(al), al)
    zero = torch.zeros_like(al)
    be = torch.where(small, zero, (p + z0 - q / al_s) / 2.0)
    ga = torch.where(small, zero, (p + z0 + q / al_s) / 2.0)
    # al ~ 0: biquadratic, y^2 = roots of w^2 + p w + r.
    dq = torch.clamp(p * p / 4.0 - r, min=0.0)
    be = torch.where(small, -(-p / 2.0 + torch.sqrt(dq)), be)
    ga = torch.where(small, -(-p / 2.0 - torch.sqrt(dq)), ga)

    def quad_roots(B_, C_):
        disc = B_ * B_ / 4.0 - C_
        s = torch.sqrt(torch.clamp(disc, min=0.0))
        return -B_ / 2.0 + s, -B_ / 2.0 - s, disc >= 0.0

    r1, r2, ok12 = quad_roots(al, be)
    r3, r4, ok34 = quad_roots(-al, ga)
    roots = torch.stack([r1, r2, r3, r4], dim=-1) - (a / 4.0)[..., None]
    valid = torch.stack([ok12, ok12, ok34, ok34], dim=-1)
    c4, c3, c2, c1, c0 = (x[..., None] for x in (c4, c3, c2, c1, c0))
    res = ((roots * c4 * roots + c3 * roots + c2) * roots + c1) * roots + c0
    scale = torch.clamp(
        torch.abs(c4) * torch.abs(roots) ** 4 + torch.abs(c3) * torch.abs(roots) ** 3
        + torch.abs(c2) * roots * roots + torch.abs(c1) * torch.abs(roots) + torch.abs(c0),
        min=_EPS,
    )
    return roots, valid & (torch.abs(res) / scale < 1e-4)


def _procrustes_3pt(Pw: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """Rigid T_cw with Pc ~= R Pw + t from 3 correspondences:
    Pw (..., 3, 3), Pc (..., 3, 3) (points x coordinates) -> (..., 4, 4)."""
    cw = Pw.mean(dim=-2)
    cc = Pc.mean(dim=-2)
    H = (Pw - cw[..., None, :]).transpose(-1, -2) @ (Pc - cc[..., None, :])
    u, _, vt = torch.linalg.svd(H)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.linalg.det(v @ ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = v @ D @ ut
    t = cc - (R @ cw[..., None])[..., 0]
    return se3.from_Rt(R, t)


def p3p_poses(X_w: torch.Tensor, pn: torch.Tensor):
    """Solve P3P for 3-point samples.

    Args:
      X_w: (..., 3, 3) world points.
      pn: (..., 3, 2) normalized image coordinates (x/z, y/z).

    Returns (T (..., 4, 4, 4) candidate poses T_cw, valid (..., 4) bool).
    """
    f = torch.cat([pn, torch.ones_like(pn[..., :1])], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)          # bearing vectors

    A0_ = ((X_w[..., 1, :] - X_w[..., 2, :]) ** 2).sum(-1)
    B0_ = ((X_w[..., 0, :] - X_w[..., 2, :]) ** 2).sum(-1)
    C0_ = ((X_w[..., 0, :] - X_w[..., 1, :]) ** 2).sum(-1)
    world_scale = torch.sqrt(torch.clamp((A0_ + B0_ + C0_) / 3.0, min=_EPS))
    X = X_w / world_scale[..., None, None]
    A, B, C = A0_ / world_scale ** 2, B0_ / world_scale ** 2, C0_ / world_scale ** 2
    ca = (f[..., 1, :] * f[..., 2, :]).sum(-1)
    cb = (f[..., 0, :] * f[..., 2, :]).sum(-1)
    cg = (f[..., 0, :] * f[..., 1, :]).sum(-1)

    # Quartic in v = s3/s1 (sympy resultant; see the JAX module).
    A4 = A**2 - 2*A*B - 2*A*C + B**2 - 4*B*C*ca**2 + 2*B*C + C**2
    A3 = 4.0 * (-A**2*cb + A*B*ca*cg + A*B*cb + 2*A*C*cb - B**2*ca*cg
                + 2*B*C*ca**2*cb + B*C*ca*cg - B*C*cb - C**2*cb)
    A2 = 2.0 * (2*A**2*cb**2 + A**2 - 4*A*B*ca*cb*cg - 2*A*B*cg**2
                - 4*A*C*cb**2 - 2*A*C + 2*B**2*ca**2 + 2*B**2*cg**2 - B**2
                - 2*B*C*ca**2 - 4*B*C*ca*cb*cg + 2*C**2*cb**2 + C**2)
    A1 = 4.0 * (-A**2*cb + A*B*ca*cg + 2*A*B*cb*cg**2 - A*B*cb + 2*A*C*cb
                - B**2*ca*cg + B*C*ca*cg + B*C*cb - C**2*cb)
    A0 = A**2 - 4*A*B*cg**2 + 2*A*B - 2*A*C + B**2 - 2*B*C + C**2

    v, v_ok = quartic_real_roots(A4, A3, A2, A1, A0)              # (..., 4)
    A, B, C, ca, cb, cg = (x[..., None] for x in (A, B, C, ca, cb, cg))
    Q2 = 1.0 + v * v - 2.0 * v * cb                              # = B / s1^2
    s1 = torch.sqrt(B / torch.clamp(Q2, min=_EPS))
    # e1 - e2 = 0 is linear in u: 2B(cg - v ca) u = (A - C) Q2 + B (1 - v^2).
    den = 2.0 * B * (cg - v * ca)
    u = ((A - C) * Q2 + B * (1.0 - v * v)) / torch.where(torch.abs(den) < _EPS,
                                                         torch.full_like(den, _EPS), den)
    s2, s3 = u * s1, v * s1
    ok = v_ok & (Q2 > _EPS) & (s1 > 0) & (s2 > 0) & (s3 > 0) & (torch.abs(den) > 1e-9)

    depths = torch.stack([s1, s2, s3], dim=-1)                   # (..., 4, 3)
    Pc = depths[..., :, :, None] * f[..., None, :, :]            # (..., 4, 3, 3)
    finite = torch.isfinite(Pc).all(-1).all(-1)
    Pc = torch.where(finite[..., None, None], Pc, torch.zeros_like(Pc))
    Xk = X[..., None, :, :].expand(Pc.shape)
    T = _procrustes_3pt(Xk, Pc)                                  # (..., 4, 4, 4), unit scale
    # The pose must reproduce the depths (Procrustes of an inconsistent
    # depth triple is silently wrong).
    Pc_hat = (T[..., None, :3, :3] @ Xk[..., None])[..., 0] + T[..., None, :3, 3]
    fit = torch.linalg.norm(Pc_hat - Pc, dim=-1).amax(-1)
    ok = ok & finite & (fit < 1e-3)
    # Undo the world rescale: R is scale-free, t scales with the world.
    T = se3.from_Rt(T[..., :3, :3], T[..., :3, 3] * world_scale[..., None, None])
    return T.to(torch.float32), ok
