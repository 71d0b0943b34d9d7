#!/usr/bin/env python
"""The world-circuit evaluation of the PyTorch port (``stereoslam_tpu_torch``).

Runs :func:`stereoslam_tpu_torch.eval.run_world_eval` at the canonical
parameters (548 frames of the 240x376 city circuit, trained CALC at the
shipped thresholds, loop closing ON and the loop-OFF baseline) and prints the
record as one JSON line, with the device it ran on.  The counterpart of
``scripts/eval_world.py`` for the JAX package; it imports no JAX.

Usage:
  python scripts/torch_eval_world.py                  # on the card
  python scripts/torch_eval_world.py --device cpu     # on the CPU (about 15 min per pass)
  python scripts/torch_eval_world.py --device cpu --frames 60 --no-vo-baseline
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from stereoslam_tpu_torch import eval as E

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=0, help="0 = the canonical 548")
    ap.add_argument("--no-vo-baseline", action="store_true", help="skip the loop-OFF pass")
    args = ap.parse_args()

    t0 = time.perf_counter()
    rec = E.run_world_eval(n_frames=args.frames, vo_baseline=not args.no_vo_baseline,
                           device=args.device)
    dev = torch.device(args.device)
    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
