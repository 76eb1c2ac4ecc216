"""host_ms_per_forward (ms, the program's spans): the median host-clock
duration of the traced window's `dit.forward` spans, in milliseconds: how
long the host takes to hand one DiT forward to the card."""

from benchmark.harness import percentile
from benchmark.spans import forwards


def read(rec):
    fwd = forwards(rec)
    if fwd is None:
        return None
    return 1e3 * percentile([e - s for (s, e), _, _ in fwd], 50)
