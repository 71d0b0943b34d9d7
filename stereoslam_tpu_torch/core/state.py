"""Fixed-shape SLAM state containers (port of ``stereoslam_tpu/core/state.py``).

The whole map lives in preallocated tensors addressed by integer ids, with
the JAX package's field names, shapes and dtypes (counters are 0-dim int32
tensors).  Id conventions: landmark/keyframe slot index == id, ``-1`` means
"no link".  Pipeline stages are functions ``state -> state`` that return new
tensors and leave their inputs untouched.

The loop-closure database (``LoopState``) arrives with the loop-closing port.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig

INITING, TRACKING_GOOD, TRACKING_BAD, LOST = 0, 1, 2, 3  # frontend.h:19


class TrackState(NamedTuple):
    """Per-frame feature tracks (reference frame.h:52)."""

    xy: torch.Tensor      # (N, 2) f32 — feature positions in the current left image
    lm_idx: torch.Tensor  # (N,) i32 — landmark id or -1
    valid: torch.Tensor   # (N,) bool


class FrontendState(NamedTuple):
    """Everything the tracking loop carries frame to frame.  The frame pose is
    stored relative to the reference keyframe (``T_cw = T_rk @ kf_T_cw[ref_kf]``,
    reference frame.h:41-47), so BA rewrites of keyframe poses carry over."""

    tracks: TrackState
    T_rk: torch.Tensor      # (4, 4) pose relative to the reference KF
    T_vel: torch.Tensor     # (4, 4) constant-velocity model: T_rk' = T_vel @ T_rk
    ref_kf: torch.Tensor    # () i32 — reference keyframe id
    status: torch.Tensor    # () i32 — INITING/GOOD/BAD/LOST
    frame_id: torch.Tensor  # () i32


class MapState(NamedTuple):
    """Global + active map (reference map.h:74-79) as flat tensors."""

    kf_T_cw: torch.Tensor        # (K, 4, 4)
    kf_timestamp: torch.Tensor   # (K,) f32 seconds (host keeps exact f64 copies)
    kf_frame_id: torch.Tensor    # (K,) i32
    kf_valid: torch.Tensor       # (K,) bool
    kf_feat_xy: torch.Tensor     # (K, N, 2) f32
    kf_feat_lm: torch.Tensor     # (K, N) i32
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_prev: torch.Tensor        # (K,) i32 — previous KF id
    kf_rel_prev: torch.Tensor    # (K, 4, 4) — T_cw_this @ inv(T_cw_prev)
    kf_loop: torch.Tensor        # (K,) i32 — loop KF id or -1
    kf_rel_loop: torch.Tensor    # (K, 4, 4)
    n_kf: torch.Tensor           # () i32
    lm_pos: torch.Tensor         # (L, 3) f32
    lm_valid: torch.Tensor       # (L,) bool
    lm_outlier: torch.Tensor     # (L,) bool
    lm_first_kf: torch.Tensor    # (L,) i32 — first observing KF
    lm_obs_count: torch.Tensor   # (L,) i32 — KF observations
    n_lm: torch.Tensor           # () i32
    active_kf: torch.Tensor      # (W,) i32, -1 for empty, oldest -> newest
    n_active: torch.Tensor       # () i32
    last_ba_frame: torch.Tensor  # () i32 — frame id of the last windowed BA

    @property
    def capacity_kf(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def capacity_lm(self) -> int:
        return self.lm_valid.shape[0]


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_track_state(cfg: SlamConfig, device) -> TrackState:
    n = cfg.features.max_features
    return TrackState(
        xy=torch.zeros((n, 2), dtype=torch.float32, device=device),
        lm_idx=torch.full((n,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def init_frontend_state(cfg: SlamConfig, device) -> FrontendState:
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return FrontendState(
        tracks=init_track_state(cfg, device),
        T_rk=eye,
        T_vel=eye.clone(),
        ref_kf=_i32(-1, device),
        status=_i32(INITING, device),
        frame_id=_i32(0, device),
    )


def init_map_state(cfg: SlamConfig, device) -> MapState:
    K, L = cfg.map.max_keyframes, cfg.map.max_landmarks
    N, W = cfg.features.max_features, cfg.map.active_window
    f32, i32 = torch.float32, torch.int32
    eye = torch.eye(4, dtype=f32, device=device).expand(K, 4, 4)
    return MapState(
        kf_T_cw=eye.clone(),
        kf_timestamp=torch.zeros((K,), dtype=f32, device=device),
        kf_frame_id=torch.zeros((K,), dtype=i32, device=device),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        kf_feat_xy=torch.zeros((K, N, 2), dtype=f32, device=device),
        kf_feat_lm=torch.full((K, N), -1, dtype=i32, device=device),
        kf_feat_valid=torch.zeros((K, N), dtype=torch.bool, device=device),
        kf_prev=torch.full((K,), -1, dtype=i32, device=device),
        kf_rel_prev=eye.clone(),
        kf_loop=torch.full((K,), -1, dtype=i32, device=device),
        kf_rel_loop=eye.clone(),
        n_kf=_i32(0, device),
        lm_pos=torch.zeros((L, 3), dtype=f32, device=device),
        lm_valid=torch.zeros((L,), dtype=torch.bool, device=device),
        lm_outlier=torch.zeros((L,), dtype=torch.bool, device=device),
        lm_first_kf=torch.full((L,), -1, dtype=i32, device=device),
        lm_obs_count=torch.zeros((L,), dtype=i32, device=device),
        n_lm=_i32(0, device),
        active_kf=torch.full((W,), -1, dtype=i32, device=device),
        n_active=_i32(0, device),
        last_ba_frame=_i32(-(1 << 30), device),
    )


def init_all(cfg: SlamConfig, device) -> Tuple[FrontendState, MapState]:
    return init_frontend_state(cfg, device), init_map_state(cfg, device)


# ---------------------------------------------------------------------------
# Scatters with JAX ``mode="drop"`` semantics: an index equal to the table
# size writes nowhere.  Torch raises on out-of-range indices, so the write
# goes to one extra dump row that is sliced off.
# ---------------------------------------------------------------------------

def _with_dump_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[:1])])


def drop_set(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for idx in [0, len(x)]."""
    out = _with_dump_row(x)
    out[idx.long()] = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    return out[:-1]


def drop_add(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].add(val, mode="drop")`` for idx in [0, len(x)]."""
    out = _with_dump_row(x)
    idx = idx.long()
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device).expand(idx.shape + x.shape[1:])
    return out.index_add_(0, idx, val)[:-1]
