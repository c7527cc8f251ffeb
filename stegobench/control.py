"""Readings that a cell's limits are set from, on the card, at the cell's
own size: the program's checks over a dozen seeds or more (the lower
readings) and those of the control, the plain reference put in the
program's place and computed in TF32 (the upper readings), in one process.

    python3 stegobench/control.py --workload <name> --seeds 101,102,... \
        --control-seeds 201,202,203 --seconds 5 [--out readings.jsonl]

Each run is a whole cell run (set-up from the seed, a short window, the
check) with the limits printed beside each number; one JSON line a run:
{"workload", "seed", "control", "correct", "checks", "attempted"}. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from stegobench.run import run_cell

    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in runs:
            t0 = time.perf_counter()
            res, _ = run_cell(ROOT, args.workload, seed, args.seconds, False,
                              args.device, t0, control=control)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "control": control, "correct": res["correct"],
                               "attempted": res["attempted"],
                               "failed": res["failed"],
                               "checks": res["checks"],
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
