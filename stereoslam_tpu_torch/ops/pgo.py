"""Global pose-graph optimization: Gauss-Newton with Jacobi-preconditioned
conjugate gradients (port of ``stereoslam_tpu/ops/pgo.py``; reference g2o
pose graph, loopclosing.cpp:537-646, residual ``log(meas^-1 T_i T_j^-1)``,
g2o_types.h:161-167).

Edge Jacobians are forward-mode derivatives of the residual (``torch.func``,
as the JAX package uses ``jacfwd``).  Vertices are gathered by index and
edge terms added into their vertices with ``index_put_(accumulate=True)``,
which adds in a fixed order on the card; the JAX package's one-hot (E, K)
selection matmuls are an MXU idiom for the same sums.  The GN and CG
``while_loop``s are Python loops that read their exit test from the device
once per iteration.  The GN step's system (:func:`_normal_equations`) and the
CG iteration are shared with the edge-sharded solver,
``parallel/dist_pgo.py``, through a hook that reduces each vertex sum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.schur import _sum_by_slot


class PoseGraph(NamedTuple):
    poses: torch.Tensor         # (K, 4, 4) initial T_cw per vertex
    vertex_valid: torch.Tensor  # (K,) bool
    fixed: torch.Tensor         # (K,) bool — not updated (gauge + anchors)
    edge_i: torch.Tensor        # (E,) int32 — "this" vertex
    edge_j: torch.Tensor        # (E,) int32 — "last"/"loop" vertex
    edge_meas: torch.Tensor     # (E, 4, 4) measured T_i @ inv(T_j)
    edge_valid: torch.Tensor    # (E,) bool


def _edge_residual(xi_i, xi_j, T_i, T_j, meas_inv):
    Ti = se3.exp(xi_i) @ T_i
    Tj = se3.exp(xi_j) @ T_j
    return se3.log(meas_inv @ Ti @ se3.inv(Tj))


def _edge_jacobians(T_i, T_j, meas_inv):
    """Residuals (E, 6) at xi = 0 and their exact Jacobians (E, 6, 6) with
    respect to each end's twist: one forward-mode pass per tangent axis."""
    z = torch.zeros(T_i.shape[:-2] + (6,), dtype=T_i.dtype, device=T_i.device)
    basis = torch.eye(6, dtype=T_i.dtype, device=T_i.device)[:, None, :].expand((6,) + z.shape)

    def jac(fn):
        cols = torch.func.vmap(lambda t: torch.func.jvp(fn, (z,), (t,))[1])(basis)
        return cols.permute(1, 2, 0)                              # (E, residual, twist)

    r = _edge_residual(z, z, T_i, T_j, meas_inv)
    J_i = jac(lambda x: _edge_residual(x, z, T_i, T_j, meas_inv))
    J_j = jac(lambda x: _edge_residual(z, x, T_i, T_j, meas_inv))
    return r, J_i, J_j


def _inv6x6(M: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD inverse via Cholesky solves (NaN where the
    factorization fails, as ``jnp.linalg.cholesky`` gives)."""
    L, info = torch.linalg.cholesky_ex(M)
    eye = torch.eye(6, dtype=M.dtype, device=M.device).expand(M.shape)
    y = torch.linalg.solve_triangular(L, eye, upper=False)
    out = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return torch.where((info == 0)[:, None, None], out, torch.full_like(out, float("nan")))


def _normal_equations(poses: torch.Tensor, free: torch.Tensor, edge_i: torch.Tensor,
                      edge_j: torch.Tensor, meas_inv: torch.Tensor, edge_w: torch.Tensor,
                      damping: float, reduce: Callable[[torch.Tensor], torch.Tensor]):
    """One GN step's system over the given edges: the right-hand side ``b``,
    ``H @ v`` and the Jacobi preconditioner, each vertex sum passed through
    ``reduce`` (the identity on one device; a sum over the ranks that hold
    the rest of the edge list in ``parallel/dist_pgo.py``)."""
    K = poses.shape[0]
    dt = poses.dtype
    freec = free[:, None]
    zero6 = torch.zeros((K, 6), dtype=dt, device=poses.device)
    ei, ej = edge_i.long(), edge_j.long()

    def to_vertices(vals_i, vals_j):
        return _sum_by_slot(vals_i, ei, K) + _sum_by_slot(vals_j, ej, K)

    r, J_i, J_j = _edge_jacobians(poses[ei], poses[ej], meas_inv)
    J_i, J_j = J_i * edge_w, J_j * edge_w  # edge_w is {0, 1}: weights r, b, D and Hv alike
    bD = reduce(torch.cat([
        to_vertices(-torch.einsum("eki,ek->ei", J_i, r), -torch.einsum("eki,ek->ei", J_j, r)),
        to_vertices(torch.einsum("eki,ekj->eij", J_i, J_i),
                    torch.einsum("eki,ekj->eij", J_j, J_j)).reshape(K, 36)], dim=1))
    b = torch.where(freec, bD[:, :6], zero6)
    D = bD[:, 6:].reshape(K, 6, 6)
    M_inv = _inv6x6(D + (damping + 1e-4) * torch.eye(6, dtype=dt, device=D.device))

    def Hv(v):
        v = torch.where(freec, v, zero6)
        a = torch.einsum("ekl,el->ek", J_i, v[ei]) + torch.einsum("ekl,el->ek", J_j, v[ej])
        out = reduce(to_vertices(torch.einsum("eki,ek->ei", J_i, a),
                                 torch.einsum("eki,ek->ei", J_j, a)))
        return torch.where(freec, out + damping * v, zero6)

    def precond(v):
        return torch.where(freec, torch.einsum("kij,kj->ki", M_inv, v), zero6)

    return b, Hv, precond


def _cg_step(Hv, precond, x, rr, p, rz):
    """One preconditioned CG iteration: (x, residual, direction, r.z)."""
    Hp = Hv(p)
    alpha = rz / torch.clamp((p * Hp).sum(), min=1e-20)
    x = x + alpha * p
    rr = rr - alpha * Hp
    z = precond(rr)
    rz_new = (rr * z).sum()
    p = z + rz_new / torch.clamp(rz, min=1e-20) * p
    return x, rr, p, rz_new


def _orthonormalized(poses: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Remove accumulated rotation drift from the free vertices.  The SVD
    raises on non-finite input, and a diverged pose must stay non-finite
    for the caller's gate."""
    finite = torch.isfinite(poses).all(-1).all(-1)
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(poses.shape)
    poses_on = se3.orthonormalize(torch.where(finite[:, None, None], poses, eye))
    return torch.where((free & finite)[:, None, None], poses_on, poses)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def optimize_pose_graph(
    graph: PoseGraph,
    gn_iters: int = 20,
    cg_iters: int = 64,
    damping: float = 1e-6,
    cg_rtol: float = 1e-6,
    gn_xtol: float = 3e-4,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Optimize and return new (K, 4, 4) poses; fixed and invalid vertices
    stay bit for bit.  GN stops after ``gn_iters`` steps or once the largest
    twist step is at most ``gn_xtol``; CG after ``cg_iters`` steps or once the
    preconditioned residual drops to ``cg_rtol`` of its start.  ``stats``, if
    given, receives the GN and total CG iteration counts."""
    free = graph.vertex_valid & ~graph.fixed
    freec = free[:, None]
    ew = graph.edge_valid.to(graph.poses.dtype)[:, None, None]
    meas_inv = se3.inv(graph.edge_meas)
    zero6 = torch.zeros((graph.poses.shape[0], 6), dtype=graph.poses.dtype,
                        device=graph.poses.device)

    poses = graph.poses
    gn, cg_total = 0, 0
    while gn < gn_iters:
        b, Hv, precond = _normal_equations(poses, free, graph.edge_i, graph.edge_j, meas_inv, ew,
                                           damping, _identity)
        z = precond(b)
        rz0 = (b * z).sum()
        x, rr, p, rz = zero6, b, z, rz0
        k = 0
        while k < cg_iters and bool(rz > cg_rtol * rz0):
            x, rr, p, rz = _cg_step(Hv, precond, x, rr, p, rz)
            k += 1
        cg_total += k
        poses = torch.where(free[:, None, None], se3.exp(x) @ poses, poses)
        gn += 1
        if not bool(torch.where(freec, x, zero6).abs().amax() > gn_xtol):
            break
    if stats is not None:
        stats.update(gn_iters=gn, cg_iters=cg_total)
    return _orthonormalized(poses, free)
