"""The program's own spans in a traced window, for the metrics that read
them (`metrics/kernels_per_forward.py`, `host_ms_per_forward.py`,
`forward_idle_pct.py`).

The port records spans at its block, forward, text and decode boundaries
(`inferix_tpu_torch.profiling.profiler.spans`) while a torch.profiler
session runs, which a `--trace 1` run's window is: each with its host start
and end on time.perf_counter's scale, the window's `Record` clock, and the
device times of its two CUDA events on the same scale. `Record.to_ns` puts
both on the profiler's clock, beside `Record.kernels`.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from benchmark.harness import MetricError, Record

FORWARD = "dit.forward"


def forwards(rec: Record) -> Optional[List[Tuple[Tuple[float, float], Tuple[int, int],
                                                 List[Tuple[int, int]]]]]:
    """Each DiT forward of the window: (its host (start, end) in seconds,
    its device [start_ns, end_ns) on the profiler's clock, the device events
    that start inside that interval as (start_ns, end_ns)); None where the
    run was not traced or the program keeps no span store. Raises
    MetricError where the window holds no forward span, or a forward's
    device interval holds no device event (the two clocks out of step)."""
    if not rec.kernels:
        return None
    try:
        from inferix_tpu_torch.profiling.profiler import spans
    except ImportError:
        return None
    fwd = [sp for sp in spans(rec.t0, rec.t1) if sp.name == FORWARD]
    if not fwd:
        raise MetricError(f"no {FORWARD} span in the traced window "
                          f"({len(rec.kernels)} device events)")
    events = sorted((s, e) for _, s, e in rec.kernels)
    starts = [s for s, _ in events]
    out = []
    for sp in fwd:
        lo, hi = rec.to_ns(sp.device[0]), rec.to_ns(sp.device[1])
        inside = events[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]
        if not inside:
            raise MetricError(f"a {FORWARD} span's device interval [{lo}, {hi}) ns holds "
                              "no device event: the spans' and the profiler's clocks "
                              "are out of step")
        out.append((sp.host, (lo, hi), inside))
    return out
