"""Readings that set a cell's correctness limits, on the card, in one
process (the benchmark's own runs do not run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 7 8 9] [--variant NAME=JSON ...] [--seconds 1] [--out FILE]

For each seed, one run of the cell (a short window: one clip or one walk
step suffices to read the check) with the program as configured, then with
the cell's control (its file's check.control.patch: the program's own path
one precision below the configuration's), then each extra variant (a patch
of the configuration, e.g. another lower-precision path, read for
PERF.md). Prints each run's compared numbers and, per number, the largest
reading of the program and the smallest of the control, as JSON lines (and
into --out when given).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=JSON: a configuration patch read on the control seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    runs = [("program", s, False, None) for s in args.seeds]
    runs += [("control", s, True, None) for s in args.control_seeds]
    for v in args.variant:
        name, patch = v.split("=", 1)
        runs += [(name, s, False, {"config": json.loads(patch)}) for s in args.control_seeds]
    out = open(args.out, "a") if args.out else None
    readings = {}
    for label, seed, control, patch in runs:
        t0 = time.perf_counter()
        try:
            res = harness.run_cell(args.workload, seed, args.seconds, False, control=control,
                                   patch=patch, metrics=[], log=lambda m: None)
            checks = {k: v["value"] for k, v in res["checks"].items()}
        except Exception as exc:  # a run that fails gives no number: report it, go on
            checks = {"error": repr(exc)}
        line = {"run": label, "seed": seed, "checks": checks,
                "seconds": round(time.perf_counter() - t0, 3)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for k, v in checks.items():
            if k != "error":
                readings.setdefault(label, {}).setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    summary = {label: {k: {"max": max(v), "min": min(v), "n": len(v)} for k, v in d.items()}
               for label, d in readings.items()}
    print(json.dumps({"summary": summary, "card": harness.card_info()}), flush=True)
    if out:
        out.write(json.dumps({"summary": summary}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
