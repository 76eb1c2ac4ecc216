"""frames_per_s (frames/s, host clock): pixel frames delivered by every step
of the window over the window's whole wall time (whole steps, from the end
of the warm-up)."""


def read(rec):
    frames = sum(st.frames for st in rec.steps)
    return frames / rec.window_s if rec.steps and frames else None
