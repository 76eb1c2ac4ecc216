"""step_mfu_pct (%, device trace run): every model operation of the
window's steps (DiT forwards, reruns, text K/V, VAE decodes), each at its
precision's published peak, over the traced window's wall time."""

from benchmark.counts import ops_time


def read(rec):
    work = rec.work()
    if not work or not rec.kernels:
        return None
    return 100.0 * sum(ops_time(w, rec.peaks) for w in work) / rec.window_s
