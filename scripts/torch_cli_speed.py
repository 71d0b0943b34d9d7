#!/usr/bin/env python
"""Frame rate of the port's CLI path against the facade driven directly, on
``chip_smoke.py`` phase main's 100 KITTI-geometry frames (1241x376, seed 11),
interleaved in one process so that the host's load falls on every variant
alike.

Variants, each a fresh ``StereoSlam`` (loop closing off, inline BA) over all
frames:
  facade  ``process_frame`` on the frames in memory, the card synchronised
          after each frame (phase main's loop)
  feed    ``DeviceFeed`` over the frames in memory, then ``process_staged``
  cli     ``stereoslam_tpu_torch.run.main --no-loop`` on the frames written as
          a KITTI directory (``kitti.frames`` decodes the PNGs, then
          ``DeviceFeed``, then ``process_staged``)
They run in the order facade, feed, cli, cli, feed, facade, ``--reps`` times.
Each run reports FPS by ``process_staged`` latency and FPS by the time between
``process_staged`` entries (what the loop around it adds included), both over
the frames after the 12 warm-up frames, and the p50 latency.  Every run must
write the same trajectory.  Prints the card's name and power limit, one JSON
line per run, and the medians per variant as the last line.

Usage (on the card)::

    python scripts/torch_cli_speed.py [--reps 2]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from stereoslam_tpu_torch import run as cli  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.utils.feed import DeviceFeed  # noqa: E402

ORDER = ("facade", "feed", "cli", "cli", "feed", "facade")


def clock_entries(slam, entries):
    """Record the time of each ``process_staged`` entry of ``slam``."""
    staged = slam.process_staged

    def timed(lr, ts):
        entries.append(time.perf_counter())
        return staged(lr, ts)

    slam.process_staged = timed


def run_variant(name, seq, cfg, kitti_dir: Path, out: Path, dev):
    """One run; returns (StereoSlam, process_staged entry times, trajectory bytes)."""
    entries = []
    frames = [(seq.left[t], seq.right[t], float(seq.timestamps[t])) for t in range(len(seq.left))]
    if name == "cli":
        slams = []
        rc = cli.main([str(kitti_dir / "config.yaml"), str(kitti_dir), "--output", str(out),
                       "--no-loop", "--device", str(dev)],
                      on_slam=lambda s: (slams.append(s), clock_entries(s, entries)))
        if rc != 0:
            raise SystemExit(f"the CLI returned {rc}")
        slam = slams[0]
    else:
        slam = StereoSlam(cfg, device=dev, enable_loop=False)
        clock_entries(slam, entries)
        if name == "facade":
            for left, right, ts in frames:
                if not slam.process_frame(left, right, ts):
                    break
                if dev.type == "cuda":
                    torch.cuda.synchronize()
        else:
            for lr, ts in DeviceFeed(frames, device=dev):
                if not slam.process_staged(lr, ts):
                    break
        slam.save_trajectory(str(out / "trajectory.txt"))
    return slam, entries, (out / "trajectory.txt").read_bytes()


def measure(seq, cfg, dev, reps: int, warmup: int):
    records = []
    with tempfile.TemporaryDirectory(prefix="cli_speed_") as tmp:
        kitti_dir = Path(tmp) / "kitti"
        kitti_dir.mkdir()
        chip_smoke.write_kitti_dir(seq, cfg, kitti_dir)
        want = None
        for rep in range(reps):
            for k, name in enumerate(ORDER):
                out = Path(tmp) / f"{rep}_{k}_{name}"
                out.mkdir()
                slam, entries, traj = run_variant(name, seq, cfg, kitti_dir, out, dev)
                if want is None:
                    want = traj
                if traj != want:
                    raise SystemExit(f"{name} (rep {rep}) wrote another trajectory than the first run")
                lat = np.asarray(slam.frame_latency_ms[warmup:])
                gaps = np.diff(entries[warmup:])
                rec = {"rep": rep, "variant": name, "frames": len(slam.frame_latency_ms),
                       "fps_latency": round(float(len(lat) / lat.sum() * 1e3), 3),
                       "fps_entries": round(float(len(gaps) / gaps.sum()), 3),
                       "p50_ms": round(float(np.median(lat)), 3)}
                print(json.dumps(rec), flush=True)
                records.append(rec)
                del slam
    summary = {name: {key: float(np.median([r[key] for r in records if r["variant"] == name]))
                      for key in ("fps_latency", "fps_entries", "p50_ms")}
               for name in dict.fromkeys(ORDER)}
    return records, summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement runs on the card")
    print(f"card: {chip_smoke.card_line()}", flush=True)
    seq = chip_smoke.kitti_sequence()
    _, summary = measure(seq, chip_smoke.kitti_config(seq), torch.device("cuda", 0), args.reps,
                         chip_smoke.WARMUP)
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
