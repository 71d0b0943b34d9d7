"""Multi-process runtime: process-group initialization, global meshes and the
one collective of the sharded ops (port of
``stereoslam_tpu/parallel/distributed.py``).

The JAX package follows the multi-controller model: every process runs the
same program, one mesh spans all devices, and ``shard_map`` bodies combine
their partial results with ``psum``/``all_gather``.  The port keeps the
model with one device per process:

- every process runs the same program and calls :func:`initialize`
  (torchrun's environment, or the arguments);
- :func:`global_mesh` is a (data, model) ``DeviceMesh`` over all ranks;
- the sharded ops (``dist_lcd``, ``dist_pgo``, ``dist_ba``, ``multiseq``)
  take the replicated global inputs, compute on their rank's shard and
  combine through :func:`all_reduce` over one named mesh dimension.

Every combination in this package is a sum, a max or a min, so
:func:`all_reduce` is the only collective: no ``all_gather``.  Gloo carries
CUDA tensors for ``all_reduce`` (and ``broadcast``) but not for
``all_gather``, so the same code runs on NCCL, on Gloo over the CPU, and on
Gloo over CUDA tensors (several ranks on one card, which NCCL refuses).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from stereoslam_tpu_torch.parallel.mesh import (_BACKEND, axis_index, axis_size, make_mesh,
                                               mesh_device)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Join the multi-process runtime.

    Arguments left ``None`` come from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT`` as ``tcp://addr:port``, ``WORLD_SIZE``,
    ``RANK``).  Returns False, and starts nothing, when that describes a
    single process (``make_mesh`` then makes its own world of one); True
    once the process group is up.  The backend is NCCL for ``device="cuda"``
    and Gloo for ``"cpu"`` unless ``backend`` names one; a backend that
    fails to start raises, it is never swapped for another.  On the card a
    rank uses device ``LOCAL_RANK`` (else ``rank``) modulo the device count,
    so several ranks may share one card (over Gloo)."""
    if init_method is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size in (None, 1):
        return False
    if init_method is None or rank is None:
        raise ValueError(f"{world_size} processes need an init_method and a rank")
    if device not in _BACKEND:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') and no CUDA device is available: "
                               "pass device='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or _BACKEND[device], init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return True


def global_mesh(
    dp: Optional[int] = None,
    mp: Optional[int] = None,
    data_axis: str = "data",
    model_axis: str = "model",
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (data, model) mesh over every process's device; the axis
    conventions of :func:`~stereoslam_tpu_torch.parallel.mesh.make_mesh`."""
    return make_mesh(dp=dp, mp=mp, data_axis=data_axis, model_axis=model_axis,
                     device_type=device_type)


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the ranks along the named mesh dimension
    (``"sum"``, ``"max"`` or ``"min"``) and return it: every rank of the
    dimension then holds the same values.  The one collective of the
    sharded ops; on the card it reads nothing back, and NCCL's may be
    captured in a CUDA graph.  Over one rank it leaves ``t`` as it is."""
    dist.all_reduce(t, op=_OPS[op], group=mesh.get_group(axis))
    return t


def host_local_array(mesh: DeviceMesh, axis: str, local) -> torch.Tensor:
    """The global tensor whose rows are each rank's ``local`` rows in rank
    order along ``axis`` (every rank passes as many), held whole on every
    rank: ``jax.make_array_from_process_local_data`` with the rows sharded
    over ``axis``.  Assembled by one sum: each rank writes its rows into
    zeros; bool tensors travel as int32."""
    local = torch.as_tensor(np.asarray(local) if not isinstance(local, torch.Tensor) else local)
    local = local.to(mesh_device(mesh))
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    rows = local.shape[0]
    wire = torch.int32 if local.dtype == torch.bool else local.dtype
    out = torch.zeros((n * rows,) + tuple(local.shape[1:]), dtype=wire, device=local.device)
    out[r * rows:(r + 1) * rows] = local.to(wire)
    all_reduce(out, mesh, axis)
    return out.to(local.dtype)


def replicated_array(mesh: DeviceMesh, value) -> torch.Tensor:
    """``value`` (the same on every process) on this rank's device of the mesh."""
    if isinstance(value, torch.Tensor):
        return value.to(mesh_device(mesh))
    return torch.as_tensor(np.asarray(value), device=mesh_device(mesh))


def fetch_replicated(t: torch.Tensor) -> np.ndarray:
    """A replicated result read on any process, as numpy."""
    return t.detach().cpu().numpy()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
