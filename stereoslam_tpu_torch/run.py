"""CLI driver: run stereo SLAM on a KITTI sequence (port of
``stereoslam_tpu/run.py``).

The counterpart of the reference app (reference
app/run_kitti_stereo.cpp:30-105: ``run_kitti_stereo config.yaml
sequence_dir`` — per-frame loop with timing, progress prints every 100
frames, trajectory + loop-edge dumps, average FPS report)::

    python -m stereoslam_tpu_torch.run CONFIG SEQUENCE_DIR [--output DIR]
                                       [--max-frames N] [--no-loop] [--no-backend]
                                       [--gt POSES] [--plot-every N] [--device DEV]

It runs on the card unless ``--device cpu`` is given; with no card it fails
when the system is built.  ``map.ply`` is written before ``map3d.png``, so it
does not depend on matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Callable, Optional

import numpy as np

# Named, not __name__: under ``python -m`` this module is __main__.
log = logging.getLogger("stereoslam_tpu_torch.run")


def main(argv=None, on_slam: Optional[Callable] = None) -> int:
    """Run the CLI on ``argv``.  ``on_slam``: called with the ``StereoSlam``
    once it is built, for callers that read its profiler or state."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", help="reference-style OpenCV YAML config")
    parser.add_argument("sequence_dir", help="KITTI sequence dir (times.txt, image_0/, image_1/)")
    parser.add_argument("--output", default="result", help="output directory")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--no-loop", action="store_true")
    parser.add_argument("--no-backend", action="store_true")
    parser.add_argument("--gt", default="", help="optional KITTI gt poses file for ATE report")
    parser.add_argument(
        "--plot-every",
        type=int,
        default=0,
        metavar="N",
        help="write an incremental trajectory/map plot to OUTPUT/live.png "
        "every N frames (the Viewer role, reference viewer.cpp:35-101 — but "
        "off the frame loop: rendering happens between frames, and costs "
        "nothing when 0/off; needs matplotlib)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device the system runs on (default: the card)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")

    from stereoslam_tpu_torch.config import load_config
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.utils import kitti
    from stereoslam_tpu_torch.utils.feed import DeviceFeed

    cfg = load_config(args.config)
    slam = StereoSlam(cfg, device=args.device, enable_backend=not args.no_backend,
                      enable_loop=not args.no_loop)
    if on_slam is not None:
        on_slam(slam)

    os.makedirs(args.output, exist_ok=True)
    live = None
    if args.plot_every > 0:
        from stereoslam_tpu_torch.utils.viewer import LiveView

        live = LiveView(args.output)
    t0 = time.time()
    n = 0
    last_left = None

    def _host_frames():
        nonlocal last_left
        for i, (left, right, ts) in enumerate(kitti.frames(args.sequence_dir)):
            if args.max_frames and i >= args.max_frames:
                return
            if live is not None:
                last_left = left
            yield left, right, ts

    # Frame t+1's stereo pair uploads while frame t computes (utils/feed.py).
    for lr, ts in DeviceFeed(_host_frames(), device=slam.device):
        ok = slam.process_staged(lr, ts)
        n += 1
        if n % 100 == 0:
            log.info("frame %d (%.1f FPS)", n, n / (time.time() - t0))
        if live is not None and n % args.plot_every == 0:
            live.update(slam, last_left)
        if not ok:
            log.warning("tracking lost — stopping (reference behavior)")
            break
    dt = time.time() - t0
    log.info("processed %d frames in %.1fs (%.1f FPS avg)", n, dt, n / dt)

    traj_path = os.path.join(args.output, "trajectory.txt")
    edges_path = os.path.join(args.output, "loopEdges.txt")
    slam.save_trajectory(traj_path)
    slam.save_loop_edges(edges_path)
    log.info("saved %s (+ %d loop edges in %s)", traj_path, len(slam.loop_edges), edges_path)

    # Final 3D map scene + PLY export (the reference Pangolin viewer's 3D
    # content, viewer.cpp:249-267, rendered offline).
    try:
        from stereoslam_tpu_torch.utils.viewer import export_ply, plot_map_3d

        _, _, T_cw = slam.keyframe_trajectory()
        lm_pos = slam.map.lm_pos.cpu().numpy()
        lm_ok = (slam.map.lm_valid & ~slam.map.lm_outlier).cpu().numpy()
        export_ply(T_cw, lm_pos, lm_ok, slam.loop_edges,
                   out_path=os.path.join(args.output, "map.ply"))
        plot_map_3d(T_cw, lm_pos, lm_ok, slam.loop_edges,
                    out_path=os.path.join(args.output, "map3d.png"))
        log.info("saved 3D map scene (map.ply, map3d.png)")
    except Exception as e:  # visualization must never fail the run
        log.warning("3D map export failed: %s", e)

    if args.gt:
        from stereoslam_tpu_torch.utils.metrics import ate_rmse

        gt_all = kitti.load_gt_poses(args.gt)
        ids, _, T_cw = slam.keyframe_trajectory()
        fid = slam.map.kf_frame_id[: len(ids)].cpu().numpy()
        est_T_wc = np.linalg.inv(T_cw.astype(np.float64))
        ate = ate_rmse(est_T_wc, gt_all[fid], align=True)
        log.info("ATE RMSE vs ground truth: %.3f m over %d keyframes", ate, len(ids))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
