"""device_idle_pct (%, device trace): the share of the traced window's
wall time in which no device operation ran (the union of the profiler's
kernel, copy and memset intervals)."""


def read(rec):
    if not rec.kernels:
        return None
    return 100.0 * (1.0 - rec.busy_ns() / 1e9 / rec.window_s)
