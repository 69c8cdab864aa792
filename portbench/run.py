"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Without a CUDA card (or with fewer cards than
the cell asks for) it exits 2 and prints no result. The last line of
standard output is the result object; the numbers the run compared, each
beside its limit, are the last lines of standard error and the result's
last key. `--fault` breaks the timed path on purpose (the control runs).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()

    from portbench import harness

    try:
        result = harness.run_workload(args.workload, args.seed, args.seconds, bool(args.trace),
                                      t_start=T_START, fault=args.fault)
    except harness.NoCard as e:
        print(f"portbench: {args.workload}: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: no module of JAX or of the JAX package may load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
