"""Device-mesh construction (port of ``stereoslam_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
"data" and a "model" axis.  The port runs one device per process, so a mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with the same two named dimensions: rank ``r`` sits
at ``(r // mp, r % mp)``.  A sharded op reduces over one named dimension
through that dimension's process group (``parallel/distributed.py``
``all_reduce``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_world(device_type: str) -> None:
    """A single process with no process group gets a world-size-1 group on a
    store held in memory, as a single JAX process has its local devices."""
    if dist.is_initialized():
        return
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh builds a mesh of CUDA devices by default and no CUDA "
                           "device is available: pass device_type='cpu' for a CPU mesh")
    dist.init_process_group(_BACKEND[device_type], store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(
    dp: Optional[int] = None,
    mp: Optional[int] = None,
    data_axis: str = "data",
    model_axis: str = "model",
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (data, model) mesh over every rank of the process group.

    Defaults, as in JAX: every rank on the model axis (the descriptor
    database, edge list and landmark sharding axis), ``dp=1``.  Raises
    ``ValueError`` when ``dp * mp`` is not the number of ranks."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    _ensure_world(device_type)
    n = dist.get_world_size()
    if dp is None and mp is None:
        dp, mp = 1, n
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    return init_device_mesh(device_type, (dp, mp), mesh_dim_names=(data_axis, model_axis))


def replicated(mesh: DeviceMesh) -> Tuple[Replicate, ...]:
    """The placements of a tensor held whole on every rank of ``mesh``."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along the named dimension (JAX ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along the named dimension (JAX
    ``lax.axis_index`` inside ``shard_map``)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
