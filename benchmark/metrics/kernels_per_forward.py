"""kernels_per_forward (count, the program's spans over the device trace):
the device events (every kernel, cuBLAS's, the plain passes' and the
port's own, and copies and memsets) whose start lies inside a `dit.forward`
span's device interval, over the number of those spans in the traced
window: the launches of one DiT forward, counted where the work runs."""

from benchmark.spans import forwards


def read(rec):
    fwd = forwards(rec)
    if fwd is None:
        return None
    return sum(len(events) for _, _, events in fwd) / len(fwd)
