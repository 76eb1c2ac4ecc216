"""linear_roofline_pct (%, device trace): the DiT's dense products (its
linears, and the cross-attention's two products over the text tokens, which
run as GEMMs) at their least time, from the shapes, over the device time of
the GEMM kernels (and quantization prologues) that this metric's pattern
file counts, inside the steps' DiT spans."""

from pathlib import Path

from benchmark.counts import least_time

PATTERNS = Path(__file__).with_suffix(".patterns.json")


def read(rec):
    work = rec.work({"linear", "cross_attention"}, span="dit")
    if not work or not rec.kernels:
        return None
    return 100.0 * sum(least_time(w, rec.peaks) for w in work) / rec.kernel_seconds(PATTERNS)
