"""The world-circuit accuracy evaluation (port of ``stereoslam_tpu/eval.py``
``run_world_eval``).

Drive the ray-cast city circuit (``utils/world.py``, exact ground truth) for
``laps`` laps at the SHIPPED default thresholds (trained CALC descriptor,
similarity 0.94/0.92, ``database_min_size`` 50, ``id_gap`` 20; reference
KITTI00-02.yaml:79-88) and report ATE, keyframe rate, and loop edges with
their ground-truth separation: the stand-in for the reference's saved KITTI-00
artifacts.  The record has the JAX package's keys: ``ate_m`` (loop closing
ON) and ``ate_vo_m`` (the same frames with loop closing OFF), and ``fps`` /
``latency_ms_p50`` that exclude the first ``EVAL_WARMUP`` frames.

The evaluation runs on the card unless the caller asks for ``device="cpu"``.
Frames rendered on the device the system runs on are staged from there;
host frames go through :class:`~stereoslam_tpu_torch.utils.feed.DeviceFeed`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

# Canonical evaluation parameters, as in the JAX package.
WORLD_LENGTH = 90.0
WORLD_WIDTH = 50.0
WORLD_H = 240
WORLD_W = 376
WORLD_STEP = 0.8
WORLD_SEED = 1
WORLD_LAPS = 1.3
EVAL_WARMUP = 15  # frames excluded from fps/latency (kernel builds and warm-up live here)


def default_world_frames(laps: float = WORLD_LAPS) -> int:
    from stereoslam_tpu_torch.utils.world import frames_per_lap

    return int(frames_per_lap(WORLD_STEP, WORLD_LENGTH, WORLD_WIDTH) * laps)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive(slam, seq, n: int):
    """Stream ``n`` frames through ``slam``.  Returns (lost_at, count,
    steady_fps) with the first EVAL_WARMUP frames excluded from the clock,
    which is read after the device has finished."""
    from stereoslam_tpu_torch.utils.feed import DeviceFeed

    dev = slam.device
    if torch.is_tensor(seq.left) and seq.left.device.type == dev.type:
        feed = ((torch.stack([seq.left[t], seq.right[t]]).to(dev, torch.uint8),
                 float(seq.timestamps[t])) for t in range(n))
    else:
        feed = DeviceFeed(((seq.left[t], seq.right[t], seq.timestamps[t]) for t in range(n)),
                          device=dev)
    lost_at = None
    count = 0
    t_steady = None
    for lr, ts in feed:
        if count == EVAL_WARMUP:
            _sync(dev)
            t_steady = time.perf_counter()
        if not slam.process_staged(lr, ts):
            lost_at = count
            break
        count += 1
    slam._drain()
    _sync(dev)
    steady = count - EVAL_WARMUP
    fps = 0.0
    if t_steady is not None and steady > 0:
        wall = time.perf_counter() - t_steady
        fps = steady / wall if wall > 0 else 0.0
    return lost_at, count, fps


def _traj_ate(slam, seq) -> float:
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    fids, est = slam.frame_trajectory()
    est = est.astype(np.float64)
    gt = np.linalg.inv(seq.T_cw[fids].astype(np.float64))
    gt = np.linalg.inv(gt[0]) @ gt
    return float(ate_rmse(np.linalg.inv(est), gt, align=False))


def _edge_gt_dist(T_cw: np.ndarray, kf_frame_id: np.ndarray, edges) -> list:
    """Ground-truth distance (m) between the two keyframes of each edge."""
    out = []
    for cur, loop in edges:
        g1 = np.linalg.inv(T_cw[kf_frame_id[cur]].astype(np.float64))[:3, 3]
        g2 = np.linalg.inv(T_cw[kf_frame_id[loop]].astype(np.float64))[:3, 3]
        out.append(float(np.linalg.norm(g1 - g2)))
    return out


def run_world_eval(
    n_frames: int = 0,
    laps: float = WORLD_LAPS,
    h: int = WORLD_H,
    w: int = WORLD_W,
    step: float = WORLD_STEP,
    seed: int = WORLD_SEED,
    descriptor: str = "default",
    seq=None,
    traj_out: Optional[str] = None,
    vo_baseline: bool = True,
    cfg_overrides: Optional[dict] = None,
    device=None,
    on_slam: Optional[Callable] = None,
    readback_lag: Optional[int] = None,
) -> dict:
    """Run the full pipeline on the world circuit at shipped defaults.

    Returns a record with frames/ate_m/ate_vo_m/n_kf/kf_rate/loop_edges/
    edge_gt_dist_m/fps/lost_at.  ``seq`` may carry a pre-rendered sequence
    (it must match the parameters).  ``vo_baseline=False`` skips the loop-OFF
    pass.  ``device``: the card unless the caller asks for ``"cpu"``.
    ``on_slam``: called with each ``StereoSlam`` before it is driven (the
    loop-ON one first), for callers that time its stages or keep its state.
    ``readback_lag``: passed to both ``StereoSlam``s (None: their default).
    """
    from stereoslam_tpu_torch.config import CameraConfig, SlamConfig
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.models.calc import DescriptorModel
    from stereoslam_tpu_torch.utils import world as W

    dev = torch.device(device or "cuda")
    if descriptor not in ("default", "calc", "hog"):
        raise ValueError(f"unknown descriptor {descriptor!r}")
    n = n_frames or int(W.frames_per_lap(step, WORLD_LENGTH, WORLD_WIDTH) * laps)
    if seq is None:
        # Focal length scales with the image width so any (h, w) sees the
        # same field of view as the canonical 240x376/fx=320 camera.
        seq = W.generate_world_sequence(
            n_frames=n, h=h, w=w, fx=320.0 * w / WORLD_W, seed=seed, step=step,
            length=WORLD_LENGTH, width=WORLD_WIDTH, device=dev,
        )

    cfg = SlamConfig(
        camera=CameraConfig(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy,
            fx_right=seq.fx, fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
            bf=seq.fx * seq.baseline,
        ),
        image_height=h,
        image_width=w,
        # loop: SHIPPED DEFAULTS, deliberately not overridden.
    )
    # Pinned-threshold guard runs BEFORE overrides: the canonical record is
    # produced with cfg_overrides=None.
    if not (cfg.loop.similarity_high == 0.94 and cfg.loop.id_gap == 20):
        raise AssertionError("the shipped loop thresholds changed")
    # Pixel-denominated knobs adapt to reduced resolutions (identity at the
    # canonical 376-px width and above); explicit cfg_overrides still win.
    cfg = cfg.scaled_for_resolution()
    if cfg_overrides:
        cfg = cfg.replace(**{
            sec: dataclasses.replace(getattr(cfg, sec), **fields)
            for sec, fields in cfg_overrides.items()
        })

    def make_slam(enable_loop: bool) -> StereoSlam:
        model = DescriptorModel() if descriptor == "hog" else None
        slam = StereoSlam(cfg, device=dev, enable_backend=True, enable_loop=enable_loop,
                          readback_lag=readback_lag, descriptor_model=model)
        if on_slam is not None:
            on_slam(slam)
        return slam

    slam = make_slam(enable_loop=True)
    lost_at, count, fps = _drive(slam, seq, n)
    ate = _traj_ate(slam, seq)

    n_kf = int(slam.map.n_kf)
    edges = [(int(a), int(b)) for a, b in slam.loop_edges]
    fid = slam.map.kf_frame_id[:n_kf].cpu().numpy()
    edge_gt_dist = _edge_gt_dist(seq.T_cw, fid, edges)

    if traj_out:
        slam.save_trajectory(traj_out)

    # Loop-OFF baseline on the SAME frames: pins what the correction buys.
    ate_vo = None
    if vo_baseline:
        slam_vo = make_slam(enable_loop=False)
        vo_lost, _, _ = _drive(slam_vo, seq, n)
        ate_vo = round(_traj_ate(slam_vo, seq), 4) if vo_lost is None else None

    lat = np.asarray(slam.frame_latency_ms[EVAL_WARMUP:]
                     or slam.frame_latency_ms or [0.0])
    return {
        "frames": count,
        "lost_at": lost_at,
        "ate_m": round(ate, 4),
        "ate_vo_m": ate_vo,
        "n_kf": n_kf,
        "kf_rate": round(n_kf / max(count, 1), 4),
        "loop_edges": edges,
        "edge_gt_dist_m": [round(d, 2) for d in edge_gt_dist],
        "fps": round(fps, 2),
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 2),
        "timing_def": f"fps/latency exclude the first {EVAL_WARMUP} frames "
                      "(kernel builds and warm-up)",
        "params": {"h": h, "w": w, "step": step, "seed": seed, "frames": n,
                   "descriptor": descriptor},
        "thresholds": {
            "similarity_high": cfg.loop.similarity_high,
            "similarity_low": cfg.loop.similarity_low,
            "database_min_size": cfg.loop.database_min_size,
            "id_gap": cfg.loop.id_gap,
        },
    }
