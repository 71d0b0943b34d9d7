#!/usr/bin/env python
"""The workloads of ``scripts/ba_damping_seeds.py`` through the JAX package
(float32, the damping floor 1e-8), on the CPU: the reference beside which
the port's two damping floors are read.

Usage:
  python scripts/jax_ate_seeds.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ba_damping_seeds import (KITTI_FRAMES, KITTI_SEEDS, WORLD_FRAMES, WORLD_SEEDS,  # noqa: E402
                              _kitti_cfg, report)


def run_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import stereoslam_tpu  # noqa: F401  (sets the matmul precision)
    from stereoslam_tpu import config as C
    from stereoslam_tpu import eval as E
    from stereoslam_tpu.core.system import StereoSlam
    from stereoslam_tpu.utils.metrics import ate_rmse
    from stereoslam_tpu.utils.synthetic import generate_sequence

    for seed in KITTI_SEEDS:
        seq = generate_sequence(n_frames=KITTI_FRAMES, h=376, w=1241, fx=718.856,
                                baseline=386.1448 / 718.856, n_points=4000,
                                trajectory="forward", speed=0.8, seed=seed)
        slam = StereoSlam(_kitti_cfg(C, seq), enable_loop=False)
        lost = None
        for t in range(len(seq.left)):
            if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
                lost = t
                break
        ids, T = slam.frame_trajectory()
        gt = np.linalg.inv(seq.T_cw[ids].astype(np.float64))
        ate = float(ate_rmse(np.linalg.inv(np.asarray(T, np.float64)), gt, align=False))
        yield {"workload": "kitti", "seed": seed, "lost_at": lost, "n_kf": int(slam.map.n_kf),
               "ate_m": round(ate, 4)}
    for seed in WORLD_SEEDS:
        rec = E.run_world_eval(n_frames=WORLD_FRAMES, seed=seed, vo_baseline=False)
        yield {"workload": "world", "seed": seed, "lost_at": rec["lost_at"],
               "n_kf": rec["n_kf"], "ate_m": rec["ate_m"]}


if __name__ == "__main__":
    report("jax float32, cpu", run_jax())
