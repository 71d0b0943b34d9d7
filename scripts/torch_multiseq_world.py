#!/usr/bin/env python
"""Batched multi-sequence loop closing on the world circuit, for the PyTorch
port (``stereoslam_tpu_torch``); the counterpart of
``scripts/multiseq_world.py``, with the same record format.

Renders B world circuits (seeds 1..B, independent worlds, 548 frames by
default) on the device, drives them through ``MultiSeqVO`` with verified
loop closing ON (``verify_loops=True, kf_sub=2``) and the same frames with
loop closing OFF, and reports per sequence the keyframe-trajectory ATE both
ways, the keyframes, the detected edges and the applied corrections.  It
imports no JAX.

Usage:
  python scripts/torch_multiseq_world.py                 # on the card, prints the record
  python scripts/torch_multiseq_world.py --out rec.json  # also writes it
  python scripts/torch_multiseq_world.py --device cpu --frames 60
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def render(batch: int, frames: int, device):
    """The B world sequences, seeds WORLD_SEED .. WORLD_SEED + B - 1."""
    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.utils import world as W

    return [W.generate_world_sequence(n_frames=frames, h=E.WORLD_H, w=E.WORLD_W, fx=320.0,
                                      seed=E.WORLD_SEED + b, step=E.WORLD_STEP,
                                      length=E.WORLD_LENGTH, width=E.WORLD_WIDTH, device=device)
            for b in range(batch)]


def world_config(s0):
    """scripts/multiseq_world.py's config: the world camera, SlamConfig
    defaults otherwise."""
    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.config import CameraConfig, SlamConfig

    return SlamConfig(
        camera=CameraConfig(fx=s0.fx, fy=s0.fy, cx=s0.cx, cy=s0.cy, fx_right=s0.fx,
                            fy_right=s0.fy, cx_right=s0.cx, cy_right=s0.cy,
                            bf=s0.fx * s0.baseline),
        image_height=E.WORLD_H, image_width=E.WORLD_W,
    )


def run(vo_kwargs, seqs, cfg, n: int, device):
    """One MultiSeqVO pass over the first ``n`` frames of ``seqs``, the
    stereo stacks built from the rendered frames where they lie."""
    import torch

    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO

    B = len(seqs)
    vo = MultiSeqVO(cfg, batch=B, device=device, **vo_kwargs)

    def stack(t):
        return torch.stack([torch.stack([s.left[t], s.right[t]]) for s in seqs]).to(
            torch.uint8).to(vo.device)

    ts = lambda t: np.asarray([float(s.timestamps[t]) for s in seqs])  # noqa: E731
    lr0 = stack(0).cpu().numpy()
    vo.initialize(lr0[:, 0], lr0[:, 1], ts(0))
    for t in range(1, n):
        vo.process_staged(stack(t), ts(t))
    vo.drain()
    return vo


def kf_ate(vo, b: int, seq) -> float:
    """Keyframe-trajectory ATE of sequence ``b`` against the ground truth,
    both anchored at the first keyframe."""
    n_kf = int(vo.maps.n_kf[b])
    fid = vo.maps.kf_frame_id[b, :n_kf].cpu().numpy()
    T = vo.maps.kf_T_cw[b, :n_kf].cpu().numpy().astype(np.float64)
    est = np.linalg.inv(T)
    gt = np.linalg.inv(np.asarray(seq.T_cw)[fid].astype(np.float64))
    gt = np.linalg.inv(gt[0]) @ gt
    err = est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def experiment(batch: int = 2, frames: int = 548, device="cuda"):
    """Loop ON and OFF over the same rendered frames.  Returns (record,
    loop-ON MultiSeqVO, loop-OFF MultiSeqVO, the sequences)."""
    from stereoslam_tpu_torch import eval as E

    seqs = render(batch, frames, device)
    cfg = world_config(seqs[0])
    vo_on = run(dict(enable_loop=True, verify_loops=True, kf_sub=2), seqs, cfg, frames, device)
    vo_off = run(dict(enable_loop=False), seqs, cfg, frames, device)
    rec = {"batch": batch, "frames": frames, "per_seq": []}
    for b in range(batch):
        rec["per_seq"].append({
            "seed": E.WORLD_SEED + b,
            "ate_loop_on_m": round(kf_ate(vo_on, b, seqs[b]), 4),
            "ate_loop_off_m": round(kf_ate(vo_off, b, seqs[b]), 4),
            "n_kf": int(vo_on.maps.n_kf[b]),
            "detected_edges": vo_on.loop_edges(b),
            "applied_corrections": vo_on.loop_closures[b],
        })
    rec["all_corrected"] = all(len(s["applied_corrections"]) >= 1 for s in rec["per_seq"])
    rec["all_improved"] = all(s["ate_loop_on_m"] <= s["ate_loop_off_m"] for s in rec["per_seq"])
    return rec, vo_on, vo_off, seqs


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=548)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    args = ap.parse_args()

    rec, _, _, _ = experiment(args.batch, args.frames, args.device)
    dev = torch.device(args.device)
    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
