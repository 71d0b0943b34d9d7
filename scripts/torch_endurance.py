#!/usr/bin/env python
"""The port's reference-scale endurance run: ``run_endurance`` (10.8 laps of
the canonical world circuit, about 4,557 frames, loop closing on, a
49,152-row landmark table so that compaction fires live) on the card, its
record written as JSON with the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and the code's commit.

``--trace PATH`` also writes every frame's online pose (``current_pose``),
status, tracked and inlier counts, keyframe and landmark counts and LK
rescue passes to an npz, and prints the frames before a LOST.

Usage:
  python scripts/torch_endurance.py [--out ENDURANCE_TORCH.json] [--commit REV]
                                    [--laps 10.8] [--device cuda] [--trace trace.npz]

About 5-10 minutes on an H100.  Where the checkout has no git history,
pass the commit with ``--commit``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power.limit": limit}


def commit() -> str:
    out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="ENDURANCE_TORCH.json")
    ap.add_argument("--commit", default=None)
    ap.add_argument("--laps", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch

    import stereoslam_tpu_torch  # noqa: F401  (pins float32 matmuls)
    from stereoslam_tpu_torch import eval as E

    trace = {k: [] for k in ("pose", "status", "tracked", "inliers", "n_kf", "n_lm", "retry",
                             "deep")}

    def record(slam):
        step = slam.process_staged

        def traced(lr, ts):
            ok = step(lr, ts)
            m = slam.metrics
            for k, v in (("pose", slam.current_pose()), ("status", slam.status),
                         ("tracked", m["num_tracked"][-1] if m["num_tracked"] else -1),
                         ("inliers", m["num_inliers"][-1] if m["num_inliers"] else -1),
                         ("n_kf", int(slam.map.n_kf)), ("n_lm", int(slam.map.n_lm)),
                         ("retry", slam.rescues["retry"]), ("deep", slam.rescues["deep"])):
                trace[k].append(v)
            return ok

        slam.process_staged = traced

    t0 = time.perf_counter()
    rec = E.run_endurance(laps=args.laps or E.ENDURANCE_LAPS, device=args.device,
                          on_slam=record if args.trace else None)
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    if args.trace:
        np.savez(args.trace, **{k: np.asarray(v) for k, v in trace.items()})
        last = max(len(trace["status"]) - 25, 0)
        for t in range(last, len(trace["status"])):
            print(f"frame {t}: " + ", ".join(f"{k} {trace[k][t]}" for k in trace if k != "pose"),
                  flush=True)
    if torch.device(args.device).type == "cuda":
        rec["card"] = card()
        rec["device"] = torch.cuda.get_device_name(0)
    else:
        rec["device"] = "cpu"
    rec["torch"] = torch.__version__
    rec["commit"] = args.commit or commit()
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
        fh.write("\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
