"""The metrics that read the program's own spans (`benchmark/spans.py`:
`kernels_per_forward`, `host_ms_per_forward`, `forward_idle_pct`) on
synthetic traces, on the CPU: over spans the port's store recorded, with
device events placed inside them, and over span lists handed in, for the
cases that read nothing and the ones that must fail."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from inferix_tpu_torch.profiling import profiler

NAMES = ("kernels_per_forward", "host_ms_per_forward", "forward_idle_pct")


def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


@pytest.fixture(autouse=True)
def store(monkeypatch):
    """The port's span store, empty and off, restored after the test."""
    profiler.STORE.reset()
    monkeypatch.setattr(profiler.STORE, "sessions", 0)
    yield profiler.STORE
    profiler.STORE.reset()


def _record(t0=100.0, t1=101.0):
    rec = harness.Record({})
    rec.t0, rec.t0_ns, rec.t1 = t0, 10**18, t1
    return rec


def _fake(name, start, end):
    return SimpleNamespace(name=name, host=(start, end), device=(start, end))


def test_the_readers_over_the_stores_spans(store, monkeypatch):
    """Two forwards in the window (a third after it, a text span in it):
    the events that start inside each forward's device interval are its
    launches; the idle is each interval less its events' union."""
    monkeypatch.setattr(store, "sessions", 1)
    rec = harness.Record({})
    rec.start()
    with profiler.span("dit.text"):
        pass
    with profiler.span("semi_ar.block", block=0):
        with profiler.span("dit.forward", step=0, need_output=True):
            time.sleep(0.002)
        with profiler.span("dit.forward", step=-1, need_output=False):
            time.sleep(0.004)
    rec.stop()
    with profiler.span("dit.forward", step=0, need_output=True):
        pass
    fwd = [sp for sp in profiler.spans(rec.t0, rec.t1) if sp.name == "dit.forward"]
    assert len(fwd) == 2 and all(sp.device == sp.host for sp in fwd)
    (a0, a1), (b0, b1) = ((rec.to_ns(s), rec.to_ns(e)) for s, e in (sp.device for sp in fwd))
    qa, qb = (a1 - a0) // 4, (b1 - b0) // 4
    rec.kernels = [
        ("k", a0, a0 + qa), ("k", a0 + qa // 2, a0 + 2 * qa),    # overlapping: busy 2 q
        ("k", a1 - 1, a1 + 10**9),                              # runs past the interval
        ("k", b0 + qb, b0 + 3 * qb),                            # busy 2 q of 4
        ("k", a0 - 10**6, a0 - 1), ("k", b1, b1 + 10),          # outside both
    ]
    assert read("kernels_per_forward", rec) == 2.0
    want_ms = 1e3 * (fwd[0].host[1] - fwd[0].host[0] + fwd[1].host[1] - fwd[1].host[0]) / 2
    assert read("host_ms_per_forward", rec) == pytest.approx(want_ms)
    total = (a1 - a0) + (b1 - b0)
    idle = (a1 - a0) - (2 * qa + 1) + (b1 - b0) - 2 * qb
    assert read("forward_idle_pct", rec) == pytest.approx(100.0 * idle / total)


def test_nothing_is_read_without_a_trace_or_a_span_store(monkeypatch):
    """No device event (an untraced run) or a program with no span store
    (the parent of the store): each reader returns None, never raises."""
    rec = _record()
    monkeypatch.setattr(profiler, "spans", lambda *a: [_fake("dit.forward", 100.1, 100.2)])
    assert [read(n, rec) for n in NAMES] == [None] * 3
    rec.kernels = [("k", rec.to_ns(100.15), rec.to_ns(100.16))]
    assert read("kernels_per_forward", rec) == 1.0
    monkeypatch.delattr(profiler, "spans")
    assert [read(n, rec) for n in NAMES] == [None] * 3


@pytest.mark.parametrize("name", NAMES)
def test_a_window_without_a_forward_span_fails(name, monkeypatch):
    rec = _record()
    rec.kernels = [("k", rec.to_ns(100.15), rec.to_ns(100.16))]
    monkeypatch.setattr(profiler, "spans", lambda *a: [_fake("vae.decode", 100.1, 100.2)])
    with pytest.raises(harness.MetricError, match="no dit.forward span"):
        read(name, rec)


@pytest.mark.parametrize("name", NAMES)
def test_a_forward_without_a_device_event_fails(name, monkeypatch):
    """A forward whose device interval holds no event: the clocks are out of
    step, which a reading of 0 launches or 100% idle would hide."""
    rec = _record()
    rec.kernels = [("k", rec.to_ns(100.15), rec.to_ns(100.16))]
    monkeypatch.setattr(profiler, "spans", lambda *a: [_fake("dit.forward", 100.1, 100.2),
                                                       _fake("dit.forward", 100.3, 100.4)])
    with pytest.raises(harness.MetricError, match="out of step"):
        read(name, rec)
