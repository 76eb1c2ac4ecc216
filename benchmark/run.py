"""The benchmark of the PyTorch / CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. Makes the
cell's weights and inputs from --seed, warms up (set-up), measures for
--seconds, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer ones
(read from a torch.profiler trace of the window). The numbers compared are
printed beside their limits, last on standard error and last in the line.
Exits non-zero, printing no result, without the cards the cell asks for,
or where the process holds a module of the JAX stack or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_environment()

    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    chips = harness.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr, flush=True)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    print(f"card: {harness.card_info()}", file=sys.stderr, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}; the port must not load "
              "the JAX stack or the JAX package", file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
