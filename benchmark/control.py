#!/usr/bin/env python3
"""The control of a cell's ``correct``: the plain reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place, read by the same numbers as a run's check on the same
frames. A sound limit lies below what it reads.

    python benchmark/control.py --workload <cell> --seeds 1,2,3

On the card at the cell's own size (``--device cpu`` for a rehearsal).
One JSON line per seed, then one with the smallest reading of each
number."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import cell_spec

    spec = cell_spec(args.workload)
    spec.device, spec.trace, spec.seconds = args.device, 0, 0.0
    least = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        spec.seed, spec.t_start = seed, time.perf_counter()
        numbers = spec.driver.Frames(spec).control()
        print(json.dumps({"seed": seed, "control": numbers,
                          "seconds": time.perf_counter() - spec.t_start}),
              flush=True)
        least = {k: min(v, least.get(k, v)) for k, v in numbers.items()}
    print(json.dumps({"workload": args.workload, "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
