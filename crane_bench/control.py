"""Readings for the limits of the comparison that decides ``correct``: the
program's numbers over many seeds, the control's, and a planted fault's.

    python -m crane_bench.control --workload <name> --seeds 1,2,3 --seconds 20 [--control | --fault <name>] [--json out.json]

Each seed is one run of the cell (set-up, a window at the cell's own load,
the comparison), all in one process on the card. ``--control`` puts the
control that the cell's limits file names in the program's place (the
program's own lower-precision path, or the reference in float8); ``--fault``
plants one of ``crane_bench.faults.FAULTS`` underneath the timed path. The
benchmark's own runs do neither.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    from crane_bench import faults, run
    from crane_bench.spec import find_cell, read_json

    ap = argparse.ArgumentParser("crane_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--control", action="store_true",
                       help="the control that the cell's limits file names")
    which.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = find_cell(read_json(root / "BENCHMARK.json"), args.workload, root)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with faults.plant(args.fault):
            out = run.run_cell(cell, seed, args.seconds, False, "cuda", control=args.control,
                               t_process=t)
        row = {"seed": seed, "control": args.control, "fault": args.fault,
               "correct": out["result"]["correct"], "check": out["result"]["check"],
               "info": out["info"]["check"],
               "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, default=str, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
