"""System facade: construction, per-frame stepping, and result export
(port of the visual-odometry part of ``stereoslam_tpu/core/system.py``).

The counterpart of the reference ``System`` class (reference
src/system.cpp:18-97).  Frame outcomes are read back synchronously after
every frame — the JAX package's CPU semantics (readback lag 0) — so LOST is
reported on the frame that lost.  Loop closing, chunked dispatch,
checkpoints and the asynchronous BA path are not ported yet.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import backend as backend_mod
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core.maintenance import compact_landmarks
from stereoslam_tpu_torch.core.state import INITING, LOST, TRACKING_GOOD, init_all
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.ops.image import build_lk_pyramid
from stereoslam_tpu_torch.utils import trajectory as traj_io

log = logging.getLogger(__name__)


class StereoSlam:
    """End-to-end stereo visual odometry with windowed BA.

    Usage::

        slam = StereoSlam(cfg, device="cuda", enable_loop=False)
        for left, right, ts in frames:
            if not slam.process_frame(left, right, ts):
                break
        slam.save_trajectory("trajectory.txt")
    """

    def __init__(
        self,
        cfg: SlamConfig,
        device="cpu",
        enable_backend: bool = True,
        enable_loop: bool = False,
        inline_ba: bool = True,
    ):
        """``device``: where every tensor of the state lives.
        ``inline_ba``: run windowed BA inside the keyframe branch of the frame
        step; False runs it right after each keyframe frame."""
        if enable_loop:
            raise NotImplementedError("loop closing is not ported to stereoslam_tpu_torch yet")
        if cfg.camera.need_undistortion:
            raise NotImplementedError("undistortion is not ported to stereoslam_tpu_torch yet")
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self.enable_backend = enable_backend
        cam = cfg.camera
        self.intr_left = Intrinsics.create(cam.fx, cam.fy, cam.cx, cam.cy)
        self.intr_right = Intrinsics.create(cam.fx_right, cam.fy_right, cam.cx_right, cam.cy_right)
        self.baseline = cam.baseline
        self.fs, self.map = init_all(cfg, self.device)
        self.inline_ba = inline_ba
        self._ba = partial(backend_mod.optimize_active_map, intr=self.intr_left, cfg=cfg)
        self._pyr_prev = None
        self._frame_count = 0
        self._status = INITING
        # Exact f64 timestamps by frame id (the device keeps f32 copies).
        self._ts_by_frame: Dict[int, float] = {}
        # Per-frame (T_rk, ref_kf), resolved against the final KF table by
        # frame_trajectory().
        self._pose_log: Dict[int, Tuple[np.ndarray, int]] = {}
        self.metrics: Dict[str, List[int]] = {"num_inliers": [], "num_tracked": []}
        self._warned_kf_full = False
        self._lm_compact_threshold = int(0.9 * cfg.map.max_landmarks)
        self.compaction_count = 0

    # ------------------------------------------------------------------
    def process_frame(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> bool:
        """Track one stereo frame (System::RunStep, system.cpp:92-97).
        Returns False once tracking is LOST (frontend.cpp:64-67)."""
        if self._status == LOST:
            return False
        lr = np.stack([np.asarray(left), np.asarray(right)]).astype(np.uint8)
        return self.process_staged(torch.from_numpy(lr).to(self.device), timestamp)

    def process_staged(self, lr_u8: torch.Tensor, timestamp: float) -> bool:
        """Track one stereo frame whose stacked (2, H, W) uint8 pair already
        lies on the device."""
        if self._status == LOST:
            return False
        frame_idx = self._frame_count
        self._ts_by_frame[frame_idx] = float(timestamp)
        ts = torch.tensor(timestamp, dtype=torch.float32, device=self.device)
        left_f32 = lr_u8[0].to(torch.float32)
        lk_levels = self.cfg.tracking.lk_levels

        if self._status == INITING:
            pyr_left = build_lk_pyramid(left_f32, lk_levels)
            pyr_right = build_lk_pyramid(lr_u8[1].to(torch.float32), lk_levels)
            fs, m, kf_id, n_lm = frontend_mod.stereo_init_step(
                left_f32, pyr_left, pyr_right, self.fs, self.map, self.intr_left,
                self.intr_right, self.baseline, ts, self.cfg,
            )
            n_lm, kf_id = int(n_lm), int(kf_id)
            if n_lm >= self.cfg.features.num_features_init_good:
                self._status = TRACKING_GOOD
                self.fs = fs._replace(status=torch.tensor(TRACKING_GOOD, dtype=torch.int32,
                                                          device=self.device))
                self.map = m
                self._pose_log[frame_idx] = (np.eye(4, dtype=np.float32), kf_id)
                # The init keyframe's BA runs here even in inline mode.
                if self.enable_backend:
                    self.map = self._ba(self.map)
                log.info("stereo init: %d landmarks, KF %d", n_lm, kf_id)
            else:
                log.info("stereo init failed: only %d landmarks", n_lm)
            self._pyr_prev = pyr_left
            self._frame_count += 1
            return True

        ba_fn = self._ba if (self.enable_backend and self.inline_ba) else None
        fs, m, pyr_left, counts = frontend_mod.frame_step(
            left_f32, lambda: lr_u8[1].to(torch.float32), self._pyr_prev, self.fs, self.map,
            self.intr_left, self.intr_right, self.baseline, ts, self.cfg, ba_fn=ba_fn,
        )
        self.fs, self.map, self._pyr_prev = fs, m, pyr_left
        self._frame_count += 1
        # One readback per frame: counts and the KF-relative pose.
        packed = torch.cat([counts.to(torch.float32), fs.T_rk.reshape(-1)]).cpu().numpy()
        self._retire(frame_idx, packed)
        return self._status != LOST

    def _retire(self, frame_idx: int, packed: np.ndarray) -> None:
        """Record a frame's outcome: metrics, status, pose log, capacity
        guards, and the post-keyframe BA when BA is not inline."""
        n_inliers, n_tracked, status, kf_id, ref_kf, n_lm = (int(x) for x in packed[:6])
        self.metrics["num_inliers"].append(n_inliers)
        self.metrics["num_tracked"].append(n_tracked)
        self._status = status
        if status == LOST:
            log.warning("tracking LOST at frame %d (%d inliers)", frame_idx, n_inliers)
            return
        self._pose_log[frame_idx] = (packed[6:22].reshape(4, 4).copy(), ref_kf)
        if kf_id == -2 and not self._warned_kf_full:
            self._warned_kf_full = True
            log.error("keyframe table FULL (%d): keyframe creation saturated at frame %d — "
                      "raise map.max_keyframes for longer runs",
                      self.cfg.map.max_keyframes, frame_idx)
        if n_lm >= self._lm_compact_threshold and kf_id >= 0:
            self.map, tracks, freed = compact_landmarks(self.map, self.fs.tracks)
            self.fs = self.fs._replace(tracks=tracks)
            self.compaction_count += 1
            n_freed = int(freed)
            log.warning("landmark table at %d/%d: compacted, freed %d dead slots",
                        n_lm, self.cfg.map.max_landmarks, n_freed)
            if n_freed < self.cfg.map.max_landmarks // 20:
                log.error("landmark table nearly exhausted even after compaction "
                          "(%d free): raise map.max_landmarks", n_freed)
        if kf_id >= 0 and self.enable_backend and not self.inline_ba:
            self.map = self._ba(self.map)

    # ------------------------------------------------------------------
    @property
    def status(self) -> int:
        """Frontend status (INITING/TRACKING_GOOD/TRACKING_BAD/LOST)."""
        return self._status

    def current_pose(self) -> np.ndarray:
        """Absolute T_cw of the latest tracked frame."""
        ref = int(self.fs.ref_kf)
        T_kf = self.map.kf_T_cw[ref].cpu().numpy() if ref >= 0 else np.eye(4, dtype=np.float32)
        return self.fs.T_rk.cpu().numpy() @ T_kf

    def frame_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """(frame_ids, T_cw) for every tracked frame, each frame's relative
        pose composed with its reference KF's final (BA-refined) pose."""
        ids = np.array(sorted(self._pose_log), dtype=np.int64)
        if ids.size == 0:
            return ids, np.zeros((0, 4, 4), np.float64)
        kf_T = self.map.kf_T_cw.cpu().numpy()
        T = np.stack([self._pose_log[f][0] @ kf_T[self._pose_log[f][1]] for f in ids])
        return ids, T

    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(kf_ids, timestamps, T_cw) for all valid keyframes."""
        n = int(self.map.n_kf)
        ts_dev = self.map.kf_timestamp[:n].cpu().numpy()
        fid = self.map.kf_frame_id[:n].cpu().numpy()
        ts = np.array([self._ts_by_frame.get(int(f), float(t)) for f, t in zip(fid, ts_dev)],
                      dtype=np.float64)
        return np.arange(n), ts, self.map.kf_T_cw[:n].cpu().numpy()

    def save_trajectory(self, path: str) -> None:
        ids, ts, T = self.keyframe_trajectory()
        traj_io.save_trajectory(path, ids, ts, T)
