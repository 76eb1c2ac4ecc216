#!/usr/bin/env python3
"""The port's spans over a traced window of a benchmark cell, forward by
forward.

    python3 exp/trace_spans.py --workload wan13b-live1-clip81 --seed N [--seconds 10] [--out F]

from the repo root, on a machine with the cell's card. Runs the cell as
`benchmark/run.py --trace 1` does (set-up, a torch.profiler window of at
most 10 s, the check), then lays the program's spans
(`inferix_tpu_torch.profiling.profiler.spans`) over the trace's device
events and prints, for each `dit.forward`: its step, its host and device
milliseconds, the device events that start inside it, its idle share and
the host's microseconds a launch; the same summed by span name; the device
events whose name is a span's (there must be none: the spans carry no
profiler annotation); and one JSON line, written with the per-span rows to
F where --out is given.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SPAN_NAMES = ("semi_ar.block", "dit.forward", "dit.text", "vae.decode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="wan13b-live1-clip81")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    ap.add_argument("--out", type=Path, help="a JSON file for the line and every span's row")
    args = ap.parse_args(argv)
    harness.set_environment()

    import torch

    from inferix_tpu_torch.profiling.profiler import spans

    torch.set_num_threads(harness.HOST_THREADS)
    held = {}

    class Record(harness.Record):
        def __init__(self, peaks):
            super().__init__(peaks)
            held["rec"] = self

    harness.Record = Record
    metrics = [m for m in harness.benchmark_metrics(args.workload, True)
               if m["name"] in ("kernels_per_forward", "host_ms_per_forward",
                                "forward_idle_pct", "device_idle_pct", "dit_s_per_step")]
    result = harness.run_cell(args.workload, args.seed, args.seconds, True, metrics=metrics,
                              t_start=T_START)
    rec = held["rec"]
    events = sorted((s, e) for _, s, e in rec.kernels)
    starts = [s for s, _ in events]
    rows, by_name = [], {}
    for sp in spans(rec.t0, rec.t1):
        lo, hi = rec.to_ns(sp.device[0]), rec.to_ns(sp.device[1])
        inside = events[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]
        busy = sum(e - s for s, e in harness.union(inside, lo, hi))
        host_ms = (sp.host[1] - sp.host[0]) * 1e3
        dev_ms = (hi - lo) / 1e6
        row = {"name": sp.name, "attrs": {k: (v if isinstance(v, (int, bool)) else str(v))
                                          for k, v in sp.attrs.items()},
               "host_ms": host_ms, "device_ms": dev_ms, "events": len(inside),
               "idle_pct": 100.0 * (1 - busy / max(hi - lo, 1)),
               "host_start_lead_ms": (sp.device[0] - sp.host[0]) * 1e3,
               # the clocks' alignment at the span's edges: its first event's
               # start after its start, its end after its last event's end
               "first_event_ms": (inside[0][0] - lo) / 1e6 if inside else None,
               "after_last_ms": (hi - max(e for _, e in inside)) / 1e6 if inside else None}
        rows.append(row)
        agg = by_name.setdefault(sp.name, {"n": 0, "host_ms": 0.0, "device_ms": 0.0,
                                           "events": 0, "idle_ms": 0.0})
        agg["n"] += 1
        agg["host_ms"] += host_ms
        agg["device_ms"] += dev_ms
        agg["events"] += len(inside)
        agg["idle_ms"] += (hi - lo - busy) / 1e6
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"card: {harness.card_info()}")
    log(f"{'span':14s} {'attrs':34s} {'host ms':>9s} {'dev ms':>9s} {'events':>7s} "
        f"{'idle %':>7s} {'us/launch':>9s} {'dev-host ms':>11s} {'1st ev ms':>9s} "
        f"{'end-last':>9s}")
    for r in rows:
        per = 1e3 * r["host_ms"] / r["events"] if r["events"] else float("nan")
        edges = [float("nan") if v is None else v
                 for v in (r["first_event_ms"], r["after_last_ms"])]
        log(f"{r['name']:14s} {json.dumps(r['attrs']):34s} {r['host_ms']:9.3f} "
            f"{r['device_ms']:9.3f} {r['events']:7d} {r['idle_pct']:7.2f} {per:9.2f} "
            f"{r['host_start_lead_ms']:11.3f} {edges[0]:9.3f} {edges[1]:9.3f}")
    for name, a in by_name.items():
        log(f"{name}: {a['n']} spans, host {a['host_ms']:.3f} ms, device {a['device_ms']:.3f} "
            f"ms, {a['events']} events, idle {a['idle_ms']:.3f} ms")
    fwd = [r for r in rows if r["name"] == "dit.forward"]
    annotated = sorted({n for n, _, _ in rec.kernels if any(s in n for s in SPAN_NAMES)})
    out = {
        "workload": args.workload, "seed": args.seed, "card": harness.card_info(),
        "torch": torch.__version__, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "window_s": rec.window_s, "device_events": len(rec.kernels),
        "spans": by_name,
        "host_us_per_launch_median": statistics.median(
            1e3 * r["host_ms"] / r["events"] for r in fwd) if fwd else None,
        "device_events_named_after_spans": annotated,
        "rows": rows,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    return 0 if result["correct"] and not annotated else 1


if __name__ == "__main__":
    sys.exit(main())
