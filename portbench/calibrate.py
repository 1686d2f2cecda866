#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--precision float32]

Each seed runs the cell's window as ``run.py`` does (the set-up and the
warm-up once, for the first seed) and prints one JSON line: the seed, the
solves, and each number compared with its value. ``--precision float32``
hands the port the problems in float32, its own single-precision path:
the control, which has to come out as not correct.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precision", choices=("float64", "float32"),
                    default="float64")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != Path(__file__).resolve().parent]
    import numpy as np

    from portbench import harness
    precision = None if args.precision == "float64" else np.float32
    session = harness.Session(ROOT, args.workload, device=args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = session.run_once(seed, args.seconds, False, t_start=T_START,
                             precision=precision)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, precision=args.precision,
            correct=r["correct"], attempted=r["attempted"],
            failed=r["failed"], metrics=r["metrics"],
            checks={k: v["value"] for k, v in r["checks"].items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
