"""block_gap_p90_s (s, device events): the 90th percentile over every block
delivered in the window of the time since its stream's previous delivery
(for the window's first clip, since the window's start), each delivery the
CUDA event recorded after the block's decode."""

from benchmark.harness import percentile


def read(rec):
    gaps = [st.gap for st in rec.steps if st.gap is not None]
    return percentile(gaps, 90) if gaps else None
