"""Headline metrics from saved profiler reports (port of
`inferix_tpu/profiling/extract_metrics.py`): average step / block, frames a
second, time to the first block and device memory, out of the JSON files
`InferixProfiler.save_report` writes; aggregated across several reports.

    python -m inferix_tpu_torch.profiling.extract_metrics REPORT.json [...]
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def extract_metrics(report_path: str) -> Dict[str, Any]:
    with open(report_path) as f:
        data = json.load(f)
    summary = data.get("summary", {})
    blocks = data.get("blocks", [])
    out: Dict[str, Any] = {
        "session": summary.get("session"),
        "time_to_first_block_s": summary.get("time_to_first_block_s"),
        "num_blocks": summary.get("num_blocks", len(blocks)),
        "stages_ms": summary.get("stages_ms", {}),
    }
    if blocks:
        # time_ms is the PER-BLOCK duration (every producer resets its
        # clock after recording — semi-AR block callback, MAGI walk,
        # profile_block decorator)
        times = [b["time_ms"] for b in blocks]
        sizes = [b.get("frames", b.get("block_size", 0)) for b in blocks]
        out["avg_block_ms"] = sum(times) / len(times)
        out["max_block_ms"] = max(times)
        total_frames = sum(sizes)
        out["total_frames"] = total_frames
        total_ms = sum(times)
        if total_ms > 0:
            out["frames_per_s"] = 1000.0 * total_frames / total_ms
    mem = data.get("memory", [])
    if mem:
        out["peak_device_bytes"] = max(
            (m.get("bytes_in_use", 0) for m in mem), default=0)
    return out


def aggregate_metrics(report_paths: List[str]) -> Dict[str, Any]:
    """Min/avg/max across per-rank reports (reference aggregate pattern)."""
    per = [extract_metrics(p) for p in report_paths]
    keys = ("time_to_first_block_s", "avg_block_ms", "frames_per_s")
    agg: Dict[str, Any] = {"ranks": len(per)}
    for k in keys:
        vals = [m[k] for m in per if m.get(k) is not None]
        if vals:
            agg[k] = {"min": min(vals), "max": max(vals),
                      "avg": sum(vals) / len(vals)}
    return agg


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Extract headline metrics from profiler reports")
    p.add_argument("reports", nargs="+")
    args = p.parse_args(argv)
    if len(args.reports) == 1:
        print(json.dumps(extract_metrics(args.reports[0]), indent=1))
    else:
        print(json.dumps(aggregate_metrics(args.reports), indent=1))


if __name__ == "__main__":
    main()
