"""Backend: sliding-window bundle adjustment over the active map
(port of ``stereoslam_tpu/core/backend.py``).

Gather the active window's observations, compact the touched landmarks,
run Schur-complement LM (:mod:`stereoslam_tpu_torch.ops.schur`), then write
back poses, landmarks and outlier unlinks, refresh in-window pose-graph
edges and retire orphan landmarks (reference src/backend.cpp:126-269).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core.state import MapState, drop_add, drop_set
from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.ops.schur import BAProblem, BAResult, solve_window_ba


class BAMap(NamedTuple):
    """The map fields the windowed BA reads: :func:`optimize_active_map`
    takes this view, so the BA's CUDA graphs (``core/graphs.py``
    ``BAGraph`` and ``SteppedBA``) hold static buffers for exactly these."""

    kf_T_cw: torch.Tensor
    kf_feat_xy: torch.Tensor
    kf_feat_lm: torch.Tensor
    kf_feat_valid: torch.Tensor
    kf_prev: torch.Tensor
    kf_rel_prev: torch.Tensor
    lm_pos: torch.Tensor
    lm_valid: torch.Tensor
    lm_outlier: torch.Tensor
    lm_first_kf: torch.Tensor
    lm_obs_count: torch.Tensor
    active_kf: torch.Tensor

    @classmethod
    def of(cls, map_state) -> "BAMap":
        return cls(*(getattr(map_state, f) for f in cls._fields))

    @property
    def capacity_kf(self) -> int:
        return self.kf_T_cw.shape[0]

    @property
    def capacity_lm(self) -> int:
        return self.lm_valid.shape[0]


# The map fields the windowed BA writes.
BA_OUTPUTS = ("kf_T_cw", "kf_rel_prev", "lm_pos", "kf_feat_lm", "lm_obs_count", "lm_outlier")


def _unique_padded(ids: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.unique(ids, size=size, fill_value=fill)`` for ``ids`` of length
    ``size`` whose entries are <= fill: sorted unique values, then ``fill``.
    Built from a sort and a scatter, with no host sync."""
    s, _ = torch.sort(ids)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    out = torch.full((size,), fill, dtype=ids.dtype, device=ids.device)
    return drop_set(out, torch.where(first, pos, torch.full_like(pos, size)), s)


class Gathered(NamedTuple):
    """What the write-back reads of the window's gather."""

    kf_idx: torch.Tensor         # (W,) keyframe rows of the window, -1 where empty
    cam_valid: torch.Tensor      # (W,)
    kf_safe: torch.Tensor        # (W,) long
    obs_lm_global: torch.Tensor  # (W, N) landmark rows of the observations
    lm_safe: torch.Tensor        # (W, N) long
    obs_valid: torch.Tensor      # (W, N)
    uniq_safe: torch.Tensor      # (C,) landmark row of each compacted slot
    lm_moved: torch.Tensor       # (C,) slots whose landmark the solve moves


def gather_window(map_state, cfg: SlamConfig) -> Tuple[BAProblem, Gathered]:
    """The active window's BA problem: its observations gathered, the
    touched landmarks compacted into W * N slots (backend.cpp:126-190)."""
    W = map_state.active_kf.shape[0]
    N = map_state.kf_feat_valid.shape[1]
    C = W * N  # compacted landmark capacity: cannot overflow
    dev = map_state.lm_pos.device

    kf_idx = map_state.active_kf
    cam_valid = kf_idx >= 0
    kf_safe = torch.clamp(kf_idx, min=0).long()
    cam_T = map_state.kf_T_cw[kf_safe]
    obs_px = map_state.kf_feat_xy[kf_safe]
    obs_lm_global = map_state.kf_feat_lm[kf_safe]
    lm_safe = torch.clamp(obs_lm_global, min=0).long()
    obs_valid = (map_state.kf_feat_valid[kf_safe] & (obs_lm_global >= 0) & cam_valid[:, None]
                 & map_state.lm_valid[lm_safe] & ~map_state.lm_outlier[lm_safe])

    # Compact the touched landmark ids into C slots; the sentinel L sorts
    # after every real id.
    L = map_state.capacity_lm
    ids_flat = torch.where(obs_valid, obs_lm_global, torch.full_like(obs_lm_global, L)).reshape(-1)
    uniq = _unique_padded(ids_flat, C, L)
    slot_of_obs = torch.clamp(torch.searchsorted(uniq, ids_flat), max=C - 1).reshape(W, N)
    lm_slot_valid = uniq < L
    uniq_safe = torch.where(lm_slot_valid, uniq, torch.zeros_like(uniq)).long()

    # Fixed iff the first-observing KF is outside the window (backend.cpp:175-177).
    first_kf = map_state.lm_first_kf[uniq_safe]
    in_window = (first_kf[:, None] == kf_idx[None, :]).any(1) & (first_kf >= 0)
    lm_fixed = ~in_window
    if cfg.backend.fix_oldest_kf:
        cam_fixed = (torch.arange(W, device=dev) == 0) & cam_valid
    else:
        cam_fixed = torch.zeros((W,), dtype=torch.bool, device=dev)
    prob = BAProblem(cam_T=cam_T, cam_valid=cam_valid, cam_fixed=cam_fixed,
                     lm_pos=map_state.lm_pos[uniq_safe], lm_valid=lm_slot_valid,
                     lm_fixed=lm_fixed, obs_px=obs_px, obs_lm=slot_of_obs, obs_valid=obs_valid)
    return prob, Gathered(kf_idx, cam_valid, kf_safe, obs_lm_global, lm_safe, obs_valid,
                          uniq_safe, lm_slot_valid & ~lm_fixed)


def write_back(map_state, g: Gathered, res: BAResult):
    """The solve's poses, landmarks and outlier unlinks written into the map,
    in-window pose-graph edges refreshed, orphans retired
    (backend.cpp:193-269).  Only the fields of ``BA_OUTPUTS`` change."""
    kf_idx, cam_valid, kf_safe = g.kf_idx, g.cam_valid, g.kf_safe
    obs_lm_global, lm_safe, obs_valid = g.obs_lm_global, g.lm_safe, g.obs_valid
    K = map_state.capacity_kf
    kf_scatter = torch.where(cam_valid, kf_idx, torch.full_like(kf_idx, K))
    kf_T_cw = drop_set(map_state.kf_T_cw, kf_scatter, res.cam_T)

    # Refresh sequential pose-graph edges whose both ends were just optimized.
    prev_idx = map_state.kf_prev[kf_safe]
    prev_match = prev_idx[:, None] == kf_idx[None, :]
    prev_in = prev_match.any(1) & (prev_idx >= 0) & cam_valid
    prev_slot = torch.argmax(prev_match.to(torch.int32), dim=1)
    rel_new = res.cam_T @ se3.inv(res.cam_T[prev_slot])
    kf_rel_prev = drop_set(map_state.kf_rel_prev,
                           torch.where(prev_in, kf_idx, torch.full_like(kf_idx, K)), rel_new)

    L = map_state.capacity_lm
    lm_pos = drop_set(map_state.lm_pos,
                      torch.where(g.lm_moved, g.uniq_safe, torch.full_like(g.uniq_safe, L)),
                      res.lm_pos)

    # Outlier observations unlink feature <-> landmark (backend.cpp:236-251).
    outlier_obs = obs_valid & ~res.obs_inlier
    kf_feat_lm = drop_set(map_state.kf_feat_lm, kf_scatter,
                          torch.where(outlier_obs, torch.full_like(obs_lm_global, -1), obs_lm_global))

    # Orphans become outliers (backend.cpp:243-247), except landmarks whose
    # first-observer KF is still in the window (replenished landmarks get
    # their first KF row only at the next keyframe).
    dec_target = torch.where(outlier_obs, lm_safe, torch.full_like(lm_safe, L)).reshape(-1)
    lm_obs_count = torch.clamp(drop_add(map_state.lm_obs_count, dec_target, -1), min=0)
    window_ids = torch.where(cam_valid, kf_idx, torch.full_like(kf_idx, -2))
    first_in_window = (map_state.lm_first_kf[:, None] == window_ids[None, :]).any(1)
    orphan = map_state.lm_valid & (lm_obs_count == 0) & ~first_in_window
    return map_state._replace(
        kf_T_cw=kf_T_cw,
        kf_rel_prev=kf_rel_prev,
        lm_pos=lm_pos,
        kf_feat_lm=kf_feat_lm,
        lm_obs_count=lm_obs_count,
        lm_outlier=map_state.lm_outlier | orphan,
    )


def optimize_active_map(map_state: MapState, intr: Intrinsics, cfg: SlamConfig,
                        host_exit: Optional[bool] = None) -> MapState:
    """One backend BA pass (Backend::OptimizeActiveMap, backend.cpp:126-269).
    ``map_state`` may be a :class:`BAMap`; only the fields of
    ``BA_OUTPUTS`` change.  ``host_exit``: as for ``solve_window_ba`` (by
    default the host reads the exit tests on CPU tensors only; on CUDA
    tensors the pass reads nothing back)."""
    prob, g = gather_window(map_state, cfg)
    res = solve_window_ba(
        prob,
        intr,
        rounds=cfg.backend.ba_rounds,
        iters=cfg.backend.ba_iters,
        chi2_threshold=cfg.backend.chi2_threshold,
        huber_delta=cfg.backend.chi2_threshold,
        host_exit=host_exit,
    )
    return write_back(map_state, g, res)
