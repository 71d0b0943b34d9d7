#!/usr/bin/env python
"""The JAX package over a closed blob-world loop circuit on the CPU: the
reference figures that ``chip_smoke.py``'s ``loop`` phase is read against.

    # chip_smoke.py's loop phase: 1241x376, KITTI 00 intrinsics, default
    # feature and map sizes, tests/test_system_loop.py's loop sampled 2.25x
    # as densely, 4000 blobs of seed 8, a 6-level stereo pyramid, HOG
    # thresholds 0.975/0.970:
    JAX_PLATFORMS=cpu python scripts/jax_loop_circuit.py
    # the same circuit at the test's thresholds:
    JAX_PLATFORMS=cpu python scripts/jax_loop_circuit.py --similarity-high 0.93 --similarity-low 0.92
    # tests/test_system_loop.py itself (240x376, its feature and map sizes):
    JAX_PLATFORMS=cpu python scripts/jax_loop_circuit.py --h 240 --w 376 --fx 320 --bf 172.8 \
        --test-features --n-points 900 --seed 7 --speed 0.35 --loop-frames 120 --n-frames 150 \
        --lk-stereo-levels 4 --similarity-high 0.93 --similarity-low 0.92

The HOG descriptor is pinned and the other loop settings are the test's.
Runs loop closing ON and OFF and prints one JSON line per run: keyframes,
landmarks, loop edges with their ground-truth distance, frame ATE
(``align=False``) and wall time.  The ON run also gives the similarity scale
of its keyframe database (``deep_db``), the numbers the detection thresholds
are read against.  A KITTI-size run takes several minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=int, default=376)
    ap.add_argument("--w", type=int, default=1241)
    ap.add_argument("--fx", type=float, default=718.856)
    ap.add_argument("--bf", type=float, default=386.1448)
    ap.add_argument("--n-points", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--n-frames", type=int, default=338)
    ap.add_argument("--loop-frames", type=int, default=270)
    ap.add_argument("--speed", type=float, default=0.35 / 2.25)
    ap.add_argument("--lk-levels", type=int, default=4)
    ap.add_argument("--lk-stereo-levels", type=int, default=6)
    ap.add_argument("--similarity-high", type=float, default=0.975)
    ap.add_argument("--similarity-low", type=float, default=0.97)
    ap.add_argument("--test-features", action="store_true",
                    help="tests/test_system_loop.py's feature and map sizes instead of the defaults")
    ap.add_argument("--runs", default="on,off")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import stereoslam_tpu  # noqa: F401  (pins matmul precision)
    from stereoslam_tpu.config import (CameraConfig, FeatureConfig, LoopClosingConfig,
                                       MapConfig, SlamConfig)
    from stereoslam_tpu.core.system import StereoSlam
    from stereoslam_tpu.models.calc import DescriptorModel
    from stereoslam_tpu.utils.metrics import ate_rmse
    from stereoslam_tpu.utils.synthetic import generate_sequence

    t0 = time.perf_counter()
    seq = generate_sequence(n_frames=args.n_frames, h=args.h, w=args.w, fx=args.fx,
                            baseline=args.bf / args.fx, n_points=args.n_points,
                            trajectory="loop", loop_frames=args.loop_frames, speed=args.speed,
                            seed=args.seed)
    print(f"data: {args.n_frames} frames {args.h}x{args.w} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    base = SlamConfig(
        camera=CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                            fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                            bf=seq.fx * seq.baseline),
        features=(FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                                num_features_init_good=50, num_features_tracking_good=50,
                                num_features_tracking_bad=10)
                  if args.test_features else FeatureConfig()),
        map=MapConfig(max_keyframes=256, max_landmarks=20000) if args.test_features else MapConfig(),
        image_height=args.h, image_width=args.w,
    )
    cfg = base.replace(
        loop=LoopClosingConfig(similarity_high=args.similarity_high,
                               similarity_low=args.similarity_low, max_above_low=6,
                               database_min_size=5, id_gap=10, min_matches=10,
                               min_inliers=10, correction_threshold=0.5),
        tracking=dataclasses.replace(base.tracking, lk_levels=args.lk_levels,
                                     lk_stereo_levels=args.lk_stereo_levels),
    )
    gt = np.linalg.inv(seq.T_cw.astype(np.float64))
    for run in args.runs.split(","):
        slam = StereoSlam(cfg, enable_loop=run == "on", descriptor_model=DescriptorModel())
        t0 = time.perf_counter()
        lost = None
        for t in range(len(seq.left)):
            if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
                lost = t
                break
        ids, T = slam.frame_trajectory()
        wall = time.perf_counter() - t0
        ate = ate_rmse(np.linalg.inv(T.astype(np.float64)), gt[ids], align=False)
        kf_ids, _, _ = slam.keyframe_trajectory()
        fid = np.asarray(slam.map.kf_frame_id)[: len(kf_ids)]
        edges = [(int(c), int(lp), float(np.linalg.norm(gt[fid[c]][:3, 3] - gt[fid[lp]][:3, 3])))
                 for c, lp in (slam.loop_edges if run == "on" else [])]
        scale = similarity_scale(np.asarray(slam.loop.deep_db)[: len(kf_ids)], fid,
                                 cfg.loop.id_gap, args.loop_frames,
                                 cfg.loop.similarity_low) if run == "on" else None
        print(json.dumps({"loop": run, "h": args.h, "w": args.w, "n_points": args.n_points,
                          "seed": args.seed, "n_frames": args.n_frames, "speed": args.speed, "lk_levels": args.lk_levels,
                          "lk_stereo_levels": args.lk_stereo_levels,
                          "similarity": [args.similarity_high, args.similarity_low],
                          "test_features": args.test_features, "lost_at": lost,
                          "n_kf": int(slam.map.n_kf), "n_lm": int(slam.map.n_lm),
                          "edges": edges, "frame_ate_m": ate, "wall_s": wall,
                          "similarity_scale": scale}), flush=True)


def similarity_scale(deep, fid, id_gap: int, loop_frames: int, low: float) -> dict:
    """Over the keyframes with descriptors (the cooldown skips some) and a
    candidate at least ``id_gap`` keyframes older: the best similarity
    (count, min, max), split into true revisits (within 12 frames of the same
    place on the loop) and other places, and the number of candidates above
    ``low`` (min, median, max)."""
    have = np.linalg.norm(deep, axis=1) > 0.5
    S = deep @ deep.T
    true, other, above = [], [], []
    for k in range(len(fid)):
        cands = np.flatnonzero(have[: max(k - id_gap + 1, 0)])
        if not have[k] or cands.size == 0:
            continue
        s = S[k, cands]
        j = int(cands[np.argmax(s)])
        d = int(fid[k] - fid[j]) % loop_frames
        (true if min(d, loop_frames - d) <= 12 else other).append(float(s.max()))
        above.append(int((s > low).sum()))

    def span(v):
        return [len(v), min(v), max(v)] if v else [0, None, None]
    return {"true_revisit_best": span(true), "other_place_best": span(other),
            "candidates_above_low": [min(above), float(np.median(above)), max(above)]}

if __name__ == "__main__":
    main()
