#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``slambench/`` and
the program, ``stereoslam_tpu_torch``, on a machine with the cards the cell
asks for.  It renders one lap of the cell's drive on the card from the seed,
warms the program up on it, measures for ``--seconds`` seconds, checks the
program's outputs against the plain reference, and prints as its last line
of standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).  Earlier lines carry the run's other readings.

It exits with another code than 0, and prints no result, when the cards
are missing, when the program cannot be imported, or when JAX or the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "stereoslam_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the run must not load,
    compared whole (``stereoslam_tpu_torch`` is not ``stereoslam_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Build and kernel caches at fixed places inside the checkout: only the
    # first run of a cell in a checkout builds.  The LK kernel builds into
    # the program's own stereoslam_tpu_torch/_build/.
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH_DIR / "_cache" / "torch_extensions")
    # One process, few threads: the host drives the card from one thread.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    from slambench import harness, spec

    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"slambench: cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                    bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}: the benchmark drives the "
              f"PyTorch port only", file=sys.stderr)
        return 3
    print(json.dumps(info, default=str))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
