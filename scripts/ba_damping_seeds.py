#!/usr/bin/env python
"""ATE over seeds of the PyTorch port with the windowed BA's damping floor at
the port's value (``damping0``) or at the JAX package's (1e-8).

Two workloads, each over four seeds:
  kitti  the smoke run's main path: 100 synthetic frames at KITTI 00 geometry
         (1241x376, fx 718.856, 4000 points, 0.8 m/frame), loop closing off,
         seeds 11-14; frame ATE, align=False.
  world  the first 60 frames of ``run_world_eval`` (240x376 city circuit,
         loop closing on, no loop-OFF pass), world seeds 1-4; ``ate_m``.

Each line printed is one JSON record; the last is the summary.
``scripts/jax_ate_seeds.py`` runs the same workloads through the JAX package.

Usage:
  python scripts/ba_damping_seeds.py                 # on the card, the port's floor
  python scripts/ba_damping_seeds.py --floor 1e-8    # the JAX package's floor
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KITTI_SEEDS = (11, 12, 13, 14)
WORLD_SEEDS = (1, 2, 3, 4)
KITTI_FRAMES, WORLD_FRAMES = 100, 60


def _kitti_cfg(C, seq):
    return C.SlamConfig(
        camera=C.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                              fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                              bf=seq.fx * seq.baseline),
        features=C.FeatureConfig(), map=C.MapConfig(),
        image_height=seq.left.shape[1], image_width=seq.left.shape[2])


def _ate(T_est, T_cw_gt, ids):
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    gt = np.linalg.inv(T_cw_gt[ids].astype(np.float64))
    return float(ate_rmse(np.linalg.inv(np.asarray(T_est, np.float64)), gt, align=False))


def report(label: str, rows) -> None:
    """Print each row as a JSON line, then the summary over seeds."""
    t0 = time.perf_counter()
    out = []
    for row in rows:
        row["run"] = label
        out.append(row)
        print(json.dumps(row), flush=True)
    summary = {"run": label, "wall_s": round(time.perf_counter() - t0, 1)}
    for wl in ("kitti", "world"):
        ate = [r["ate_m"] for r in out if r["workload"] == wl]
        summary[wl] = {"ate_m": ate, "mean": round(float(np.mean(ate)), 4),
                       "median": round(float(np.median(ate)), 4),
                       "lost": sum(r["lost_at"] is not None for r in out if r["workload"] == wl)}
    print(json.dumps(summary), flush=True)


def run_torch(device: str, floor):
    from stereoslam_tpu_torch import config as C
    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.ops import schur
    from stereoslam_tpu_torch.utils.synthetic import generate_sequence

    schur.DAMPING_FLOOR = floor
    for seed in KITTI_SEEDS:
        seq = generate_sequence(n_frames=KITTI_FRAMES, h=376, w=1241, fx=718.856,
                                baseline=386.1448 / 718.856, n_points=4000,
                                trajectory="forward", speed=0.8, seed=seed)
        slam = StereoSlam(_kitti_cfg(C, seq), device=device, enable_loop=False)
        lost = None
        for t in range(len(seq.left)):
            if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
                lost = t
                break
        ids, T = slam.frame_trajectory()
        yield {"workload": "kitti", "seed": seed, "lost_at": lost, "n_kf": int(slam.map.n_kf),
               "ate_m": round(_ate(T, seq.T_cw, ids), 4)}
    for seed in WORLD_SEEDS:
        rec = E.run_world_eval(n_frames=WORLD_FRAMES, seed=seed, vo_baseline=False,
                               device=device)
        yield {"workload": "world", "seed": seed, "lost_at": rec["lost_at"],
               "n_kf": rec["n_kf"], "ate_m": rec["ate_m"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--floor", type=float, default=None,
                    help="the port's damping floor (default: damping0)")
    args = ap.parse_args()

    floor = "damping0" if args.floor is None else args.floor
    report(f"torch {args.device}, floor {floor}", run_torch(args.device, args.floor))


if __name__ == "__main__":
    main()
