#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the chip.

    python3 slambench/control.py --workload <cell> --seeds 11,12,13 --seconds 8

For each seed, in one process: one run of the cell (render, set-up,
warm-up, a window of ``--seconds``), then every number of the check for the
program against the reference (the lower readings) and for the control
against the reference (the upper readings): the reference in the precision
below the configuration's, TF32 for the float32 frame path and a float32
solve for the float64 BA.  One JSON line a seed.  The benchmark's own runs
do not run the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    from slambench import check, harness, spec

    if not torch.cuda.is_available():
        print("slambench control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.workload(args.workload)
    config = spec.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell=cell, config=config, seed=seed, device=torch.device("cuda", 0))
        harness.execute(run, args.seconds, False, t0)
        run.facade = None
        gc.collect()
        torch.cuda.empty_cache()
        res = check.evaluate(run, cell["check"]["limits"], control=True)
        print(json.dumps(dict(cell=args.workload, seed=seed, attempted=run.attempted,
                              failed=run.failed, lower=res["numbers"], upper=res["control"],
                              samples=res["samples"], correct=res["correct"],
                              seconds=time.perf_counter() - t0)), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
