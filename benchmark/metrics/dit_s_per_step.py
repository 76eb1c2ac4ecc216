"""dit_s_per_step (s, device events): the seconds of a step's DiT work (from
the step's start, the previous delivery, to a CUDA event after its last
forward), summed over the window's steps and divided by their number."""


def read(rec):
    spans = [st.spans["dit"] for st in rec.steps if "dit" in st.spans]
    return sum(e - s for s, e in spans) / len(spans) if spans else None
