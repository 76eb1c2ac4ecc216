"""The port's span store (`inferix_tpu_torch.profiling.profiler`: `span`,
`spans`, `STORE`) on the CPU: off, a span is the shared no-op and the hot
path makes no tracing call; under `torch.profiler` a tiny Self-Forcing clip
with its VAE decode in the block callback records the block, forward, text
and decode spans with their parents, attrs and ordered times; the store's
bound and reset; an enabled `InferixProfiler` session turns recording on
and reads its records' times from spans."""
from __future__ import annotations

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.profiling import profiler
from inferix_tpu_torch.profiling.profiler import STORE, span, spans
from inferix_tpu_torch.utils.params import init_params

STEPS = (1000, 750, 500, 250)
BLOCKS = 2
# tests/test_pipeline.py's tiny VAE: 8x8 latents -> 32x32 pixels
VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1,
           temperal_downsample=(True, True))


@pytest.fixture(autouse=True)
def store(monkeypatch):
    """The store empty and off (no session of another test left open),
    restored after the test."""
    STORE.reset()
    monkeypatch.setattr(STORE, "sessions", 0)
    yield STORE
    STORE.reset()


@pytest.fixture(scope="module")
def clip():
    """run(mode): a 2-block clip of 4 denoise steps through `generate` from
    text features, each block decoded in the block callback."""
    gens = {}
    for mode in ("rerun", "last_step"):
        cfg = tiny_test_config()
        cfg.runtime.denoising_step_list = STEPS
        cfg.runtime.context_mode = mode
        params = init_params(cfg.model, torch.Generator().manual_seed(0), device="cpu",
                             dtype=torch.float32)
        gens[mode] = SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu")
    vae = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
    m, r = cfg.model, cfg.runtime
    g = torch.Generator().manual_seed(1)
    text = torch.randn(1, m.text_len, m.text_dim, generator=g)
    noise = torch.randn(1, BLOCKS, r.latent_height, r.latent_width, r.latent_channels,
                        generator=g)

    def run(mode):
        gen, state = gens[mode], {"cache": None}

        def on_block(x0, bi):
            _, state["cache"] = vae.decode_chunk(x0, state["cache"], first=bi == 0)

        gen.generate(noise, gen.encode_text_context(text), block_callback=on_block,
                     generator=torch.Generator().manual_seed(2))

    run("rerun")  # a first call outside the tests' clocks
    return run


def test_off_a_span_is_the_shared_noop():
    a, b = span("dit.forward", step=0), span("semi_ar.block")
    assert a is b is profiler._NOOP
    with a as target:
        assert target is None
    assert spans() == [] and STORE.dropped == 0


def test_off_the_clip_makes_no_tracing_call(clip, monkeypatch):
    """Off: no CUDA event, no synchronize, no record_function on the hot
    path, and no span stored."""
    def refuse(*a, **k):
        raise AssertionError("a tracing call with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    clip("rerun")
    assert STORE.spans == [] and spans() == []


@pytest.mark.parametrize("mode,forwards", [("rerun", 5), ("last_step", 4)])
def test_the_clip_records_its_span_tree(clip, mode, forwards):
    """Under torch.profiler: dit.text, then per block a semi_ar.block with
    its forwards as children (step 0-3, the rerun -1 without output) and
    the block's decode after it; ids in open order, host times ordered and
    nested, device times the host times on the CPU."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        clip(mode)
    t1 = time.perf_counter()
    got = spans(t0, t1)
    steps = list(range(len(STEPS))) + [-1] * (forwards - len(STEPS))
    want = [("dit.text", None, {})]
    for b in range(BLOCKS):
        want.append(("semi_ar.block", None, {"block": b}))
        want += [("dit.forward", "block", {"step": s, "need_output": s >= 0}) for s in steps]
        want.append(("vae.decode", None, {"first": b == 0}))
    assert len(got) == len(want) == 1 + BLOCKS * (forwards + 2)
    block = None
    for sp, (name, parent, attrs) in zip(got, want):
        assert (sp.name, sp.attrs) == (name, attrs)
        if name == "semi_ar.block":
            block = sp
        assert sp.parent == (block.id if parent else None)
        assert t0 <= sp.host[0] <= sp.host[1] <= t1
        assert sp.device == sp.host
    assert [sp.id for sp in got] == sorted(sp.id for sp in got)
    assert all(a.host[0] <= b.host[0] for a, b in zip(got, got[1:]))
    by_id = {sp.id: sp for sp in got}
    for sp in got:
        if sp.parent is not None:
            p = by_id[sp.parent]
            assert p.host[0] <= sp.host[0] and sp.host[1] <= p.host[1]
    # after the session, recording is off again
    with span("dit.forward"):
        pass
    assert spans(t0) == got


def test_the_store_is_bounded_and_resets(store, monkeypatch):
    """Past its limit the store counts what it drops; a dropped span still
    times its caller's work and parents nothing it does not hold; reset()
    empties the store."""
    monkeypatch.setattr(store, "limit", 3)
    monkeypatch.setattr(store, "sessions", 1)
    with span("outer") as outer:
        for i in range(4):
            with span("inner", i=i) as sp:
                pass
    assert [s.name for s in spans()] == ["outer", "inner", "inner"]
    assert store.dropped == 2 and sp.host[0] <= sp.host[1] and outer.parent is None
    assert [s.parent for s in spans()[1:]] == [outer.id, outer.id]
    store.reset()
    assert spans() == [] and store.dropped == 0
    with span("after"):
        pass
    assert [(s.name, s.id, s.parent) for s in spans()] == [("after", 0, None)]


def test_an_enabled_profiler_session_records_and_times_from_spans(store):
    """An enabled session turns recording on until it ends; a disabled one
    does not. Step and block records made from spans take their times from
    the spans (the host's on the CPU) when the session ends."""
    off = profiler.InferixProfiler(profiler.ProfilingConfig(enabled=False))
    off.start_session("off")
    assert span("x") is profiler._NOOP and off.span("x") is profiler._NOOP
    p = profiler.InferixProfiler(profiler.ProfilingConfig(enabled=True))
    p.start_session("on")
    p.start_session("on again")  # restarted: still one hold on the store
    assert store.sessions == 1
    made = []
    for b in range(2):
        for s in range(2):
            with p.span("magi.step", step=s) as sp:
                time.sleep(0.001)
            p.record_step_spans(2 * b + s, 1.0, 1, sp)
            made.append(sp)
        p.record_block_spans(b, 1, made[-2], made[-1])
    summary = p.end_session()
    assert store.sessions == 0 and span("x") is profiler._NOOP
    ms = [(sp.host[1] - sp.host[0]) * 1e3 for sp in made]
    assert [d["time_ms"] for d in p.diffusion_steps] == pytest.approx(ms)
    assert [b["time_ms"] for b in p.blocks] == pytest.approx(
        [(made[i + 1].host[1] - made[i].host[0]) * 1e3 for i in (0, 2)])
    assert summary["num_blocks"] == 2 and summary["avg_step_ms"] == pytest.approx(sum(ms) / 4)
    assert summary["time_to_first_block_s"] == pytest.approx(made[1].host[1] - p.session_start)
    assert [s.name for s in spans()] == ["magi.step"] * 4
