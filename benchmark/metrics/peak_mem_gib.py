"""peak_mem_gib (GiB, the allocator's counter): torch.cuda's peak of
allocated bytes over the window (reset at its start)."""


def read(rec):
    return rec.window_peak_bytes / 2 ** 30 if rec.window_peak_bytes else None
