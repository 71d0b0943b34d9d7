"""Edge-sharded global pose-graph optimization (port of
``stereoslam_tpu/parallel/dist_pgo.py``).

The pose graph grows with every keyframe (reference loopclosing.cpp:545-566
builds it over all keyframes).  ``ops/pgo.py`` is matrix-free, H @ v being
two sums over the edge list, so the edge list is sharded over the mesh's
model axis and the vertex state stays replicated: each rank builds its
edges' contributions to ``b``, the Jacobi blocks ``D`` and every ``H @ v``
through the dense solver's own GN step (``ops/pgo.py``
``_normal_equations``, ``_cg_step``) and one sum over the axis completes
them.  A CG iteration sends one (K, 6) sum and one flag.

The exit rules are the JAX package's sharded ones, not the dense solver's:
CG runs while ``r.z > 1e-12 * r0.z0``, at most ``cg_iters`` times, and GN
runs exactly ``gn_iters`` times.  The CG loop runs its ``cg_iters`` steps
from the host without reading anything back: a device flag, min-reduced
over the axis, freezes the carry once the test fails, which gives the
``while_loop``'s result.  At world size 1 the solver therefore equals
``optimize_pose_graph(graph, cg_rtol=1e-12, gn_xtol=-1)`` bit for bit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.pgo import (PoseGraph, _cg_step, _normal_equations,
                                          _orthonormalized)
from stereoslam_tpu_torch.parallel.distributed import all_reduce
from stereoslam_tpu_torch.parallel.mesh import axis_index, axis_size

# The sharded CG's exit threshold on r.z relative to its start (JAX
# dist_pgo.py); float32 rarely reaches it, so CG mostly runs cg_iters steps.
CG_RTOL = 1e-12


def optimize_pose_graph_sharded(
    graph: PoseGraph,
    mesh: DeviceMesh,
    model_axis: str = "model",
    gn_iters: int = 20,
    cg_iters: int = 64,
    damping: float = 1e-6,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Sharded variant of :func:`stereoslam_tpu_torch.ops.pgo.optimize_pose_graph`.

    ``graph`` is the whole graph on every rank; rank ``r`` of the model axis
    takes edges ``[r E/n, (r+1) E/n)``, so E must be a multiple of the
    axis size (pad with ``edge_valid=False`` rows pointing at vertex 0).
    Returns the (K, 4, 4) poses, the same on every rank.  ``stats``, if
    given, receives the GN and total CG iteration counts (one host read,
    after the solve)."""
    E = graph.edge_valid.shape[0]
    n, r = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    if E % n:
        raise ValueError(f"{E} edges do not split over {n} ranks: pad the edge list to a "
                         f"multiple of the shard count")
    sl = slice(r * (E // n), (r + 1) * (E // n))
    reduce = partial(all_reduce, mesh=mesh, axis=model_axis)
    free = graph.vertex_valid & ~graph.fixed
    dt, dev = graph.poses.dtype, graph.poses.device
    ew = graph.edge_valid[sl].to(dt)[:, None, None]
    meas_inv = se3.inv(graph.edge_meas[sl])
    zero6 = torch.zeros((graph.poses.shape[0], 6), dtype=dt, device=dev)
    cg_done = torch.zeros((), dtype=torch.int32, device=dev)

    poses = graph.poses
    for _ in range(gn_iters):
        b, Hv, precond = _normal_equations(poses, free, graph.edge_i[sl], graph.edge_j[sl],
                                           meas_inv, ew, damping, reduce)
        z = precond(b)
        rz0 = (b * z).sum()
        x, rr, p, rz = zero6, b, z, rz0
        running = torch.ones((), dtype=torch.int32, device=dev)
        for _ in range(cg_iters):
            # r.z is computed from reduced, replicated vectors; the min makes
            # the decision the axis's one decision all the same.
            running = reduce(running * (rz > CG_RTOL * rz0).to(torch.int32), op="min")
            go = running.bool()
            x, rr, p, rz = (torch.where(go, new, old) for new, old in
                            zip(_cg_step(Hv, precond, x, rr, p, rz), (x, rr, p, rz)))
            cg_done = cg_done + running
        poses = torch.where(free[:, None, None], se3.exp(x) @ poses, poses)
    if stats is not None:
        stats.update(gn_iters=gn_iters, cg_iters=int(cg_done))
    return _orthonormalized(poses, free)
