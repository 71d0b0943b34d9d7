"""Sharded loop-closure descriptor database search (port of
``stereoslam_tpu/parallel/dist_lcd.py``).

The reference scans its keyframe database serially (reference
src/loopclosing.cpp:131-143: one dot product per stored keyframe).  Here
the (K, D) database is replicated and each rank of the model axis scores
its rows ``[r K/n, (r+1) K/n)`` with one matrix-vector product; the best
score, the best id and the suspect count then combine over the axis, so a
rank's scan stays O(K / n) as the run grows.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from stereoslam_tpu_torch.parallel.distributed import all_reduce
from stereoslam_tpu_torch.parallel.mesh import axis_index, axis_size


class ShardedDetectResult(NamedTuple):
    best_id: torch.Tensor     # () int32: global row index of the best match
    best_score: torch.Tensor  # () float32
    n_suspect: torch.Tensor   # () int32: scores above the low threshold


def sharded_descriptor_search(
    db: torch.Tensor,
    db_valid: torch.Tensor,
    query: torch.Tensor,
    eligible_max_id: Union[int, torch.Tensor],
    low_threshold: float,
    mesh: DeviceMesh,
    model_axis: str = "model",
) -> ShardedDetectResult:
    """Search the database for ``query``.

    Args:
      db: (K, D) descriptors, the whole database on every rank; K must be a
        multiple of the model axis's size.
      db_valid: (K,) bool.
      query: (D,).
      eligible_max_id: ids >= this are too recent (the reference's id gap,
        loopclosing.cpp:133).

    Returns the same scalars on every rank.  The winner is the lowest id
    among the maximal scores, as JAX's ``argmax`` over the gathered shard
    winners gives: a max over the ranks' best scores, then a min over the
    ids of the ranks whose best equals it."""
    K = db.shape[0]
    n, r = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    if K % n:
        raise ValueError(f"{K} database rows do not split over {n} ranks")
    rows = K // n
    sl = slice(r * rows, (r + 1) * rows)
    ids = torch.arange(r * rows, (r + 1) * rows, dtype=torch.int32, device=db.device)
    scores = db[sl] @ query
    ok = db_valid[sl] & (ids < eligible_max_id)
    scores = torch.where(ok, scores, torch.full_like(scores, -1.0))
    best = all_reduce(scores.amax().reshape(1), mesh, model_axis, op="max")
    local_id = torch.where(scores == best, ids, torch.full_like(ids, K)).amin().reshape(1)
    best_id = all_reduce(local_id, mesh, model_axis, op="min")
    n_sus = all_reduce((scores > low_threshold).to(torch.int32).sum().reshape(1), mesh, model_axis)
    return ShardedDetectResult(best_id=best_id[0], best_score=best[0], n_suspect=n_sus[0])
