#!/usr/bin/env python
"""The JAX package on a CPU over the workload of ``chip_smoke.py``'s phase
``undistort``: bench.py's undistortion-ON configuration (KITTI 00
intrinsics, 1241x376, k1 = -0.28 and k2 = 0.07 on both cameras, p1 = p2 =
0; bench.py:125-140) on phase main's 100 synthetic frames (bench.py Phase
A: 4000 points, 0.8 m/frame, seed 11), inline BA, loop closing off.

Prints one JSON line: LOST, keyframes, landmarks and the frame-trajectory
ATE (align=False, phase main's metric), with the same run undistortion OFF
beside it.  Phase ``undistort``'s band on LOST and keyframes comes from this
run.  A few minutes on a CPU.

Usage:
  python scripts/jax_undistort_run.py [--frames 100]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(n_frames: int, undistort: bool) -> dict:
    from stereoslam_tpu.config import CameraConfig, FeatureConfig, MapConfig, SlamConfig
    from stereoslam_tpu.core.system import StereoSlam
    from stereoslam_tpu.utils.metrics import ate_rmse
    from stereoslam_tpu.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=n_frames, h=376, w=1241, fx=718.856,
                            baseline=386.1448 / 718.856, n_points=4000, trajectory="forward",
                            speed=0.8, seed=11)
    k1, k2 = (-0.28, 0.07) if undistort else (0.0, 0.0)
    cfg = SlamConfig(
        camera=CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                            fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                            bf=seq.fx * seq.baseline, need_undistortion=undistort,
                            k1=k1, k2=k2, k1_right=k1, k2_right=k2),
        features=FeatureConfig(), map=MapConfig(), image_height=376, image_width=1241)
    slam = StereoSlam(cfg, enable_loop=False)
    t0 = time.perf_counter()
    lost_at = None
    for t in range(n_frames):
        if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
            lost_at = t
            break
    ids, T = slam.frame_trajectory()
    gt = np.linalg.inv(seq.T_cw[ids].astype(np.float64))
    ate = ate_rmse(np.linalg.inv(np.asarray(T, np.float64)), gt, align=False)
    return {"undistort": undistort, "frames": n_frames, "lost_at": lost_at,
            "n_kf": int(slam.map.n_kf), "n_lm": int(slam.map.n_lm), "ate_m": round(float(ate), 4),
            "wall_s": round(time.perf_counter() - t0, 1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import stereoslam_tpu  # noqa: F401  (pins float32 matmul precision)

    out = {"on": run(args.frames, True), "off": run(args.frames, False),
           "device": f"jax {jax.__version__} cpu"}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
