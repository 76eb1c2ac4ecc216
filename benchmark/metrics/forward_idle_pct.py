"""forward_idle_pct (%, the program's spans over the device trace): the
device's idle time inside the `dit.forward` spans' device intervals (each
interval's length less the union of the device events in it) as a share of
the intervals' total length: the starvation inside a forward, where the
host's dispatch of the layer loop falls behind the card. The window's other
idle, between forwards and blocks, is in `device_idle_pct` only."""

from benchmark.harness import union
from benchmark.spans import forwards


def read(rec):
    fwd = forwards(rec)
    if fwd is None:
        return None
    total = idle = 0
    for _, (lo, hi), events in fwd:
        busy = sum(e - s for s, e in union(events, lo, hi))
        total += hi - lo
        idle += hi - lo - busy
    return 100.0 * idle / total
