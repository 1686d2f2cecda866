#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It builds the cell's problems from the seed, loads (on a checkout's first
run, builds) the port's kernels, warms up, measures for ``--seconds``,
judges every solve against the plain reference and prints one JSON object
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer ones
from a profiler trace of the window). Without a CUDA card, or with fewer
cards than the cell asks for, it exits nonzero and prints no result; so it
does where jax, jaxlib, flax or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the benchmark's modules by their package name, not this folder's
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != Path(__file__).resolve().parent]
    from portbench import checks, harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    bad = checks.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the port must not load jax, "
              "jaxlib, flax or the JAX package)", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
