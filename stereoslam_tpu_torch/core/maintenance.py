"""Map maintenance: landmark-table compaction (port of
``stereoslam_tpu/core/maintenance.py``).

The landmark table is allocated bump-style (``n_lm`` only grows), so pruned
landmarks leave dead rows behind.  :func:`compact_landmarks` packs the live
rows into the lowest slots, rewrites every reference (keyframe feature links
and live tracks) and resets ``n_lm`` to the live count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereoslam_tpu_torch.core.state import MapState, TrackState


def compact_landmarks(m: MapState, tracks: TrackState) -> Tuple[MapState, TrackState, torch.Tensor]:
    """Pack live (``lm_valid & ~lm_outlier``) landmarks into the lowest slots,
    keeping their order, and remap all references.  Returns (map, tracks,
    n_freed)."""
    L = m.capacity_lm
    keep = m.lm_valid & ~m.lm_outlier
    order = torch.argsort((~keep).to(torch.int32), stable=True)   # live rows first
    new_of_old = torch.empty(L, dtype=torch.int32, device=keep.device)
    new_of_old[order] = torch.arange(L, dtype=torch.int32, device=keep.device)
    remap = torch.where(keep, new_of_old, torch.full_like(new_of_old, -1))

    def remap_idx(idx):
        return torch.where(idx >= 0, remap[torch.clamp(idx, 0, L - 1).long()], idx)

    lm_valid = keep[order]
    n_live = keep.sum().to(torch.int32)
    m2 = m._replace(
        lm_pos=m.lm_pos[order],
        lm_valid=lm_valid,
        lm_outlier=torch.zeros_like(m.lm_outlier),
        lm_first_kf=torch.where(lm_valid, m.lm_first_kf[order], torch.full_like(m.lm_first_kf, -1)),
        lm_obs_count=torch.where(lm_valid, m.lm_obs_count[order], torch.zeros_like(m.lm_obs_count)),
        n_lm=n_live,
        kf_feat_lm=remap_idx(m.kf_feat_lm),
    )
    return m2, tracks._replace(lm_idx=remap_idx(tracks.lm_idx)), m.n_lm - n_live
