#!/usr/bin/env python
"""Frame-by-frame traces of the port's world evaluation, to find where two
devices' runs of the same frames part.

The canonical circuit of ``run_world_eval`` is rendered once on the CPU and
kept as the uint8 frames the system reads, so that runs on the card and on
the CPU take the very same input.  ``run`` drives ``run_world_eval`` (loop
ON, then the loop-OFF baseline) on those frames and records, after every
frame, the online pose (``current_pose``), the tracked and inlier counts and
the keyframe count; ``compare`` prints the first frame where two traces
differ and how the difference grows.

Usage:
  python scripts/torch_world_trace.py render frames.npz                 # on the CPU
  python scripts/torch_world_trace.py render frames2.npz --frames 843   # 2 laps
  python scripts/torch_world_trace.py render card.npz --device cuda     # times the card's render
  python scripts/torch_world_trace.py run frames.npz --device cuda --out card.npz
  python scripts/torch_world_trace.py run frames.npz --device cpu --out cpu.npz   # about 30 min
  python scripts/torch_world_trace.py compare card.npz cpu.npz
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def render(out: str, device: str, n_frames: int = 0) -> None:
    import torch

    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.utils import world as W

    dev = torch.device(device)
    torch.zeros(1, device=dev)  # create the device context off the clock
    t0 = time.perf_counter()
    seq = W.generate_world_sequence(
        n_frames=n_frames or E.default_world_frames(), h=E.WORLD_H, w=E.WORLD_W, fx=320.0, seed=E.WORLD_SEED,
        step=E.WORLD_STEP, length=E.WORLD_LENGTH, width=E.WORLD_WIDTH, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    left, right = (x.to(torch.uint8).cpu().numpy() for x in (seq.left, seq.right))
    np.savez_compressed(out, left=left, right=right, T_cw=seq.T_cw, timestamps=seq.timestamps,
                        camera=np.array([seq.baseline, seq.fx, seq.fy, seq.cx, seq.cy]))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rendered {len(left)} stereo frames on {name} in {wall:.3f} s into {out}", flush=True)


def run(frames: str, device: str, out: str) -> None:
    import torch

    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.utils.world import WorldSequence

    z = np.load(frames)
    baseline, fx, fy, cx, cy = (float(v) for v in z["camera"])
    seq = WorldSequence(left=torch.from_numpy(z["left"]), right=torch.from_numpy(z["right"]),
                        T_cw=z["T_cw"], timestamps=z["timestamps"], baseline=baseline, fx=fx,
                        fy=fy, cx=cx, cy=cy)
    traces = []

    def record(slam):
        tr = {"pose": [], "tracked": [], "inliers": [], "n_kf": []}
        traces.append(tr)
        step = slam.process_staged

        def traced(lr, ts):
            ok = step(lr, ts)
            if ok:
                tr["pose"].append(slam.current_pose())
                tr["tracked"].append(slam.metrics["num_tracked"][-1] if slam.metrics["num_tracked"]
                                     else -1)
                tr["inliers"].append(slam.metrics["num_inliers"][-1] if slam.metrics["num_inliers"]
                                     else -1)
                tr["n_kf"].append(int(slam.map.n_kf))
            return ok

        slam.process_staged = traced

    t0 = time.perf_counter()
    rec = E.run_world_eval(n_frames=len(seq.left), seq=seq, device=device, on_slam=record)
    dev = torch.device(device)
    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    arrays = {f"{name}_{k}": np.asarray(v) for name, tr in zip(("on", "off"), traces)
              for k, v in tr.items()}
    np.savez(out, record=json.dumps(rec), T_cw=seq.T_cw, **arrays)
    print(json.dumps(rec), flush=True)


def compare(a: str, b: str) -> None:
    za, zb = np.load(a), np.load(b)
    for name in ("a", "b"):
        print(f"{name}: {json.loads(str((za if name == 'a' else zb)['record']))}")
    for run_name in ("on", "off"):
        pa, pb = za[f"{run_name}_pose"], zb[f"{run_name}_pose"]
        n = min(len(pa), len(pb))
        ca = -np.einsum("tji,tj->ti", pa[:n, :3, :3], pa[:n, :3, 3])   # camera centers
        cb = -np.einsum("tji,tj->ti", pb[:n, :3, :3], pb[:n, :3, 3])
        dc = np.linalg.norm(ca - cb, axis=1)
        T_gt = za["T_cw"][:n].astype(np.float64)
        c_gt = -np.einsum("tji,tj->ti", T_gt[:, :3, :3], T_gt[:, :3, 3])   # in the world
        c_gt = c_gt @ T_gt[0, :3, :3].T + T_gt[0, :3, 3]                   # in camera 0's frame
        ea, eb = np.linalg.norm(ca - c_gt, axis=1), np.linalg.norm(cb - c_gt, axis=1)
        counts = [k for k in ("tracked", "inliers", "n_kf")]
        first_count = {k: next((t for t in range(n) if za[f"{run_name}_{k}"][t]
                                != zb[f"{run_name}_{k}"][t]), None) for k in counts}
        print(f"loop {run_name.upper()}: {n} frames in both; first frame whose count differs: "
              f"{first_count}")
        for thr in (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0):
            t = next((t for t in range(n) if dc[t] > thr), None)
            print(f"  first frame with |d camera center| > {thr:g} m: {t}"
                  + ("" if t is None else f" ({dc[t]:.3e} m)"))
        marks = sorted({0, 1, 2, 5, 10, 13, 14, 20, 30, 50, 75, 100, 150, 200, 300, 400, n - 1}
                       & set(range(n)))
        print("  |d camera center| (m) by frame: "
              + ", ".join(f"{t}: {dc[t]:.2e}" for t in marks))
        print("  error against ground truth (m), a / b, by frame: "
              + ", ".join(f"{t}: {ea[t]:.3f}/{eb[t]:.3f}" for t in marks))
        t0 = first_count["tracked"]
        if t0 is not None:
            lo = max(t0 - 3, 0)
            for t in range(lo, min(t0 + 4, n)):
                row = {k: (int(za[f"{run_name}_{k}"][t]), int(zb[f"{run_name}_{k}"][t]))
                       for k in counts}
                print(f"  frame {t}: |d center| {dc[t]:.3e} m, (a, b) {row}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("out")
    r.add_argument("--device", default="cpu")
    r.add_argument("--frames", type=int, default=0, help="frames to render (default: 548)")
    g = sub.add_parser("run")
    g.add_argument("frames")
    g.add_argument("--device", default="cuda")
    g.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "render":
        render(args.out, args.device, args.frames)
    elif args.cmd == "run":
        run(args.frames, args.device, args.out)
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
