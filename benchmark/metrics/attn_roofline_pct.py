"""attn_roofline_pct (%, device trace): the self-attention calls' least
time (each the larger of its operations at the peak of its precision and
its bytes at the memory bandwidth, from the shapes the cell drove:
`counts/`) over the device time of the kernels that this metric's pattern
file counts, inside the steps' DiT spans."""

from pathlib import Path

from benchmark.counts import least_time

PATTERNS = Path(__file__).with_suffix(".patterns.json")


def read(rec):
    work = rec.work({"self_attention"}, span="dit")
    if not work or not rec.kernels:
        return None
    return 100.0 * sum(least_time(w, rec.peaks) for w in work) / rec.kernel_seconds(PATTERNS)
