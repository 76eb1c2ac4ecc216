"""The port's pipeline layer against `inferix_tpu.pipeline.self_forcing` and
its base, at tiny_test_config sizes with the tiny VAE of
tests/test_pipeline.py, float32 on the CPU, plus the modules it runs on
(`KVCacheManager`, `InteractiveSession`, `SegmentBoundary`, the config).

Both pipelines start from the same parameters and text features, and the
port draws its noise through `_draw_noise`, replaced here by the draws the
JAX pipeline makes (jax.random.key(seed), split once for the initial noise,
then once a block, each block's key split once a denoise step). Latents are
held to the TOL of tests/test_torch_semi_ar.py (1e-4), pixels to the
DECODE_TOL of tests/test_torch_vae.py (1e-4).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core import config as jconfig
from inferix_tpu.core import types as jtypes
from inferix_tpu.core.interactive import InteractiveSession as JaxSession
from inferix_tpu.kvcache import manager as jmanager
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.models.wan.causal_dit import make_kv_spec as jax_make_kv_spec
from inferix_tpu.models.wan.vae import CausalVAE as JaxVAE
from inferix_tpu.models.wan.vae import VAEConfig as JaxVAEConfig
from inferix_tpu.pipeline.self_forcing import SelfForcingPipeline as JaxPipeline
from inferix_tpu_torch.core import config as tconfig
from inferix_tpu_torch.core import types as ttypes
from inferix_tpu_torch.core.interactive import InteractiveSession as PortSession
from inferix_tpu_torch.kvcache import manager as tmanager
from inferix_tpu_torch.models.wan.causal_dit import make_kv_spec as port_make_kv_spec
from inferix_tpu_torch.models.wan.vae import CausalVAE as PortVAE
from inferix_tpu_torch.models.wan.vae import VAEConfig as PortVAEConfig
from inferix_tpu_torch.pipeline import self_forcing
from inferix_tpu_torch.pipeline.self_forcing import SelfForcingPipeline as PortPipeline
from inferix_tpu_torch.utils.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_pipeline.py's tiny VAE: 8x8 latents -> 32x32 pixels
VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1,
           temperal_downsample=(True, True))


def _configure(cfg, mode):
    r = cfg.runtime
    r.num_frames, r.frames_per_segment, r.overlap_frames = 4, 4, 1
    r.streaming_mode = mode
    return cfg


def _features(prompts, text_len, text_dim):
    """A stand-in text encoder: features seeded by the prompt, so a prompt
    update changes the generation."""
    rng = np.random.default_rng(zlib.crc32(prompts[0].encode()))
    return (rng.standard_normal((1, text_len, text_dim)) * 0.5).astype(np.float32)


def _jax_draws(pipe):
    """The port's `_draw_noise` with the JAX pipeline's draws."""
    fpb = pipe.config.model.num_frame_per_block
    n_steps = len(pipe.config.runtime.denoising_step_list)

    def draw(seed, shape):
        rng, nkey = jax.random.split(jax.random.key(seed))
        noise = torch.from_numpy(np.array(jax.random.normal(nkey, shape)))
        blk = (shape[0], fpb) + tuple(shape[2:])
        renoise = []
        for _ in range(shape[1] // fpb):
            rng, step_rng = jax.random.split(rng)
            keys = jax.random.split(step_rng, n_steps)
            renoise.append([torch.from_numpy(np.array(
                jax.random.normal(keys[i], blk, jnp.float32))) for i in range(n_steps - 1)])
        return noise, None, renoise

    return draw


def _pair(mode):
    jcfg = _configure(jconfig.tiny_test_config(), jtypes.StreamingMode(mode))
    tcfg = _configure(tconfig.tiny_test_config(), ttypes.StreamingMode(mode))
    m = jcfg.model
    jp = jax_init_params(jax.random.key(0), m, dtype=jnp.float32)
    jvae = JaxVAE(JaxVAEConfig(**VAE), key=jax.random.key(9))
    jpipe = JaxPipeline(
        jcfg, params=jp, vae=jvae, dtype=jnp.float32,
        text_encoder=lambda p: jnp.asarray(_features(p, m.text_len, m.text_dim)))
    tpipe = PortPipeline(
        tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32),
        vae=PortVAE(PortVAEConfig(**VAE),
                    params_from_numpy(jax.tree.map(np.asarray, jvae.params), "cpu",
                                      torch.float32), dtype=torch.float32, device="cpu"),
        text_encoder=lambda p: torch.from_numpy(_features(p, m.text_len, m.text_dim)),
        dtype=torch.float32, device="cpu")
    tpipe._draw_noise = _jax_draws(tpipe)
    jpipe.setup()
    tpipe.setup()
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return _pair("true_streaming")


@pytest.fixture(scope="module")
def deferred_pipes():
    return _pair("deferred_decode")


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_no_decode_returns_latents(pipes):
    jpipe, tpipe = pipes
    want = jpipe.run_text_to_video(["a cat"], decode_mode=jtypes.DecodeMode.NO_DECODE)
    got = tpipe.run_text_to_video(["a cat"], decode_mode=ttypes.DecodeMode.NO_DECODE)
    r = tpipe.config.runtime
    assert got.shape == (1, 4, r.latent_height, r.latent_width, r.latent_channels)
    _close(got, want)
    assert tpipe.kv_manager.active_requests() == []


def test_after_all_decode(pipes):
    """AFTER_ALL with return_latents: the latents, and the video (4 latent
    frames -> 13 pixel frames in [0, 1]) against the JAX decode."""
    jpipe, tpipe = pipes
    jvid, jlat = jpipe.run_text_to_video(["a dog"], seed=7, return_latents=True,
                                         decode_mode=jtypes.DecodeMode.AFTER_ALL)
    tvid, tlat = tpipe.run_text_to_video(["a dog"], seed=7, return_latents=True,
                                         decode_mode=ttypes.DecodeMode.AFTER_ALL)
    _close(tlat, jlat)
    assert tvid.shape == (1, 13, 32, 32, 3)
    assert 0.0 <= tvid.min() and tvid.max() <= 1.0
    _close(tvid, jvid, DECODE_TOL)
    # free_cache_before_vae: the cache was dropped before the decode
    assert tpipe.kv_manager.device_bytes() == jpipe.kv_manager.device_bytes() == 0


def test_profiler_records_blocks(pipes):
    jpipe, tpipe = pipes
    for pipe, mode in ((jpipe, jtypes.DecodeMode.NO_DECODE),
                       (tpipe, ttypes.DecodeMode.NO_DECODE)):
        pipe.run_text_to_video(["x"], decode_mode=mode)
    js, ts = jpipe.profiler.summary(), tpipe.profiler.summary()
    assert ts.keys() == js.keys()
    assert ts["num_blocks"] == js["num_blocks"] == 4
    assert ts["frames"] == js["frames"] == 4
    assert ts["time_to_first_block_s"] is not None
    assert set(ts["stages_ms"]) == set(js["stages_ms"]) == {
        "initialization", "diffusion_generation"}


@pytest.mark.parametrize("offload", [False, True])
@pytest.mark.parametrize("mode", ["true_streaming", "deferred_decode"])
def test_streaming_segments_with_overlap(pipes, deferred_pipes, mode, offload):
    """3 segments with a 1-frame overlap carry: segments hold only new
    frames (4, 3, 3), each within TOL of the JAX segment; the streamed pixel
    blocks (per block under TRUE_STREAMING, per segment under
    DEFERRED_DECODE) within DECODE_TOL; offload_segments gives CPU tensors
    of the same values."""
    jpipe, tpipe = pipes if mode == "true_streaming" else deferred_pipes
    assert tpipe.resolve_streaming_mode().value == mode
    jstream, tstream = [], []
    jsegs = jpipe.run_streaming_generation(
        ["prompt a", "prompt b"], num_segments=3, offload_segments=offload,
        stream_callback=lambda px: jstream.append(np.asarray(px)))
    seen = []
    tsegs = tpipe.run_streaming_generation(
        ["prompt a", "prompt b"], num_segments=3, offload_segments=offload,
        stream_callback=lambda px: tstream.append(px.numpy()),
        segment_callback=lambda lat, i: seen.append((i, lat.shape[1])))
    assert [s.shape[1] for s in tsegs] == [s.shape[1] for s in jsegs] == [4, 3, 3]
    assert seen == [(0, 4), (1, 3), (2, 3)]
    for got, want in zip(tsegs, jsegs):
        assert got.device.type == "cpu"
        _close(got, want)
    assert torch.cat(tsegs, dim=1).shape[1] == 10
    assert [s.shape for s in tstream] == [s.shape for s in jstream]
    assert len(tstream) == (10 if mode == "true_streaming" else 3)
    for got, want in zip(tstream, jstream):
        _close(got, want, DECODE_TOL)


def test_resolve_streaming_mode_auto_on_the_cpu(pipes):
    """AUTO without a card: DEFERRED_DECODE, as the JAX package picks when
    its device reports no memory stats."""
    _, tpipe = pipes
    tpipe.config.runtime.streaming_mode = ttypes.StreamingMode.AUTO
    try:
        assert tpipe.resolve_streaming_mode() == ttypes.StreamingMode.DEFERRED_DECODE
    finally:
        tpipe.config.runtime.streaming_mode = ttypes.StreamingMode.TRUE_STREAMING


def _stop_at(session_cls, segment, block):
    """A session whose status callback stops it once the pipeline reports
    `block` of `segment` done (a block-level stop from a client)."""
    holder = {}

    def on_status(st):
        if st.current_segment == segment and st.current_block == block:
            holder["s"].stop()

    holder["s"] = session_cls(status_callback=on_status)
    return holder["s"]


@pytest.mark.parametrize("case", ["plain", "prompt_update", "stop_first", "stop_block"])
def test_interactive_generation(pipes, case):
    """Interactive runs of 3 segments: a prompt update queued before the
    run (it changes the text features), a stop before the first segment
    (no segment), a stop at block 1 of segment 1 (segment 1 cut after 2 of
    its blocks, nothing after); segments and progress against the JAX run."""
    jpipe, tpipe = pipes
    out = []
    for pipe, cls in ((jpipe, JaxSession), (tpipe, PortSession)):
        session = _stop_at(cls, 1, 2) if case == "stop_block" else cls()
        if case == "prompt_update":
            session.submit_input(prompt="new world")
        if case == "stop_first":
            session.stop()
        segs = pipe.run_interactive_generation(session, "p", num_segments=3)
        out.append((segs, session.status))
    (jsegs, jst), (tsegs, tst) = out
    want_frames = {"plain": [4, 3, 3], "prompt_update": [4, 3, 3], "stop_first": [],
                   "stop_block": [4, 2]}[case]
    assert [s.shape[1] for s in tsegs] == [s.shape[1] for s in jsegs] == want_frames
    for got, want in zip(tsegs, jsegs):
        _close(got, want)
    assert tst.frames_generated == jst.frames_generated == sum(want_frames)
    assert tst.is_stopped == jst.is_stopped == case.startswith("stop")
    assert (tst.current_segment, tst.current_block) == (jst.current_segment,
                                                        jst.current_block)
    if case == "prompt_update":
        plain = tpipe.run_interactive_generation(PortSession(), "p", num_segments=1)
        assert not torch.allclose(plain[0], tsegs[0])


@pytest.mark.parametrize("decode", ["no_decode", "after_all"])
def test_image_to_video(pipes, decode):
    """run_image_to_video with a 1-frame clean prefix (fpb 1): the output
    begins with the prefix, then 3 generated frames, against the JAX run."""
    jpipe, tpipe = pipes
    r = tpipe.config.runtime
    img = (np.random.default_rng(3).standard_normal(
        (1, 1, r.latent_height, r.latent_width, r.latent_channels)) * 0.5).astype(np.float32)
    want = jpipe.run_image_to_video(["i2v"], jnp.asarray(img), num_frames=3,
                                    decode_mode=jtypes.DecodeMode(decode))
    got = tpipe.run_image_to_video(["i2v"], torch.from_numpy(img), num_frames=3,
                                   decode_mode=ttypes.DecodeMode(decode))
    if decode == "no_decode":
        assert got.shape[1] == 4
        assert torch.equal(got[:, :1], torch.from_numpy(img))
        _close(got, want)
    else:
        assert got.shape == (1, 13, 32, 32, 3)
        _close(got, want, DECODE_TOL)


def test_pipeline_refusals(pipes):
    _, tpipe = pipes
    with pytest.raises(NotImplementedError, match="parallel layer"):
        tpipe.set_disaggregated_decode(["cuda:1"])
    cfg = tconfig.tiny_test_config()
    cfg.model_path = "/nonexistent"
    with pytest.raises(NotImplementedError, match="checkpoint loader"):
        PortPipeline(cfg, dtype=torch.float32, device="cpu").setup()


def test_default_vae_follows_the_conv_impl(monkeypatch):
    """The VAE the pipeline builds (here of the tiny config): bf16 under the
    halo impls (the kernels' dtype on the card), float32 under xla; none
    under NO_DECODE. Generator parameters drawn from runtime.seed."""
    monkeypatch.setattr(self_forcing, "VAEConfig", lambda: PortVAEConfig(**VAE))
    for impl, dtype in (("xla", torch.float32), ("halo", torch.bfloat16),
                        ("halo_w8a8", torch.bfloat16)):
        cfg = tconfig.tiny_test_config()
        cfg.runtime.vae_conv_impl = impl
        pipe = PortPipeline(cfg, dtype=torch.float32, device="cpu")
        pipe.setup()
        assert pipe.vae.conv_impl == impl and pipe.vae.dtype == dtype
    cfg.runtime.decode_mode = ttypes.DecodeMode.NO_DECODE
    pipe = PortPipeline(cfg, dtype=torch.float32, device="cpu")
    pipe.setup()
    again = PortPipeline(cfg, dtype=torch.float32, device="cpu")
    again.setup()
    assert pipe.vae is None
    assert torch.equal(pipe.generator.params["head"]["head"]["w"],
                       again.generator.params["head"]["head"]["w"])


# ---------------------------------------------------------------------------
# The modules under the pipeline, each call sequence run on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("types", [jtypes, ttypes], ids=["jax", "port"])
def test_boundary_validation(types):
    with pytest.raises(ValueError):
        types.SegmentBoundary(frames_per_segment=7, frames_per_block=3)
    with pytest.raises(ValueError):
        types.SegmentBoundary(frames_per_segment=6, frames_per_block=3, overlap_frames=6)
    with pytest.raises(ValueError):
        types.SegmentBoundary(frames_per_segment=6, frames_per_block=0)
    with pytest.raises(ValueError):
        types.SegmentBoundary(frames_per_segment=6, frames_per_block=3, overlap_frames=-1)
    b = types.SegmentBoundary(frames_per_segment=21, frames_per_block=3, overlap_frames=3)
    assert b.blocks_per_segment == 7
    assert b.unique_frames(10) == 183
    assert b.unique_frames(0) == 0


def test_types_match_the_jax_package():
    for name in ("DecodeMode", "StreamingMode", "MemoryMode", "GenerationCommand",
                 "InputApplyPolicy"):
        assert [e.value for e in getattr(ttypes, name)] == \
            [e.value for e in getattr(jtypes, name)], name
    for st in (jtypes.GenerationStatus(current_segment=1, total_segments=4,
                                       current_block=3, total_blocks=7),
               jtypes.GenerationStatus()):
        port = ttypes.GenerationStatus(**{k: getattr(st, k) for k in (
            "current_segment", "total_segments", "current_block", "total_blocks",
            "start_time")})
        assert port.progress_percent == st.progress_percent


def _session_trace(cls, policy):
    """A fixed sequence of client inputs and checkpoints; returns what each
    checkpoint decided and the statuses reported."""
    reports = []
    s = cls(apply_policy=policy, status_callback=lambda st: reports.append(
        (st.current_segment, st.current_block, st.frames_generated, st.is_paused)))
    out = []

    def check(boundary, idx):
        r = s.evaluate_checkpoint(boundary, idx)
        out.append((boundary, idx, r.command.value, r.new_prompt, r.new_guidance))

    check("segment", 0)
    s.submit_input(prompt="a")
    s.submit_input(prompt="b", guidance_scale=3.0)   # latest wins
    check("block", 0)
    check("segment", 1)
    s.submit_input(guidance_scale=5.0)
    check("segment", 2)
    s.update_progress(segment=2, total_segments=4, block=1, total_blocks=7, frames=9)
    s.pause()
    out.append(("paused", s.is_paused))
    s.resume()
    out.append(("wait", s.wait_if_paused(poll_s=0.0)))
    s.stop()
    out.append(("wait_stopped", s.wait_if_paused(poll_s=0.0)))
    check("segment", 3)
    out.append(("stopped", s.is_stopped, s.is_paused))
    return out, reports


@pytest.mark.parametrize("policy", ["next_segment", "next_block", "immediate"])
def test_interactive_session_checkpoints(policy):
    want = _session_trace(JaxSession, jtypes.InputApplyPolicy(policy))
    got = _session_trace(PortSession, ttypes.InputApplyPolicy(policy))
    assert got == want


def _spec_pair(quantized):
    cfg = jconfig.tiny_test_config()
    jspec = jax_make_kv_spec(cfg.model, batch=2, latent_h=8, latent_w=8,
                             dtype=jnp.float32, quantized=quantized)
    tspec = port_make_kv_spec(tconfig.tiny_test_config().model, batch=2, latent_h=8,
                              latent_w=8, dtype=torch.float32, quantized=quantized)
    return jspec, tspec


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_kv_manager_call_sequence(quantized):
    """Slots, set_range / get_range (an int8 cache quantizes per (token,
    head) and reads back dequantized), free zeroing a slot, free_layer,
    offload / restore (port only), device_bytes and clear: every
    read equal (f32 cache), or the same int8 codes with scales within a
    float32 ulp."""
    jspec, tspec = _spec_pair(quantized)
    jm, tm = jmanager.KVCacheManager(jspec), tmanager.KVCacheManager(tspec, device="cpu")
    rng = np.random.default_rng(0)
    h, d = tspec.num_kv_heads, tspec.head_dim
    reqs = {}
    for name in ("a", "b"):
        reqs[name] = (jmanager.KVCacheRequest(name), tmanager.KVCacheRequest(name))
        assert jm.allocate_slots(reqs[name][0]) == tm.allocate_slots(reqs[name][1])
    assert tm.allocate_slots(reqs["a"][1]) == jm.allocate_slots(reqs["a"][0])
    for mgr, req in ((jm, jmanager.KVCacheRequest("c")), (tm, tmanager.KVCacheRequest("c"))):
        with pytest.raises(RuntimeError, match="no free KV cache slots"):
            mgr.allocate_slots(req)
    assert tm.device_bytes() == jm.device_bytes() == 0
    writes = [("a", 1, 5, 7), ("b", 0, 0, 64), ("b", 1, 60, 4), ("a", 0, 70, 20)]
    for name, layer, start, n in writes:
        k = (rng.standard_normal((n, h, d)) * 2).astype(np.float32)
        v = (rng.standard_normal((n, h, d)) * 2).astype(np.float32)
        jm.set_range(reqs[name][0], layer, start, jnp.asarray(k), jnp.asarray(v))
        tm.set_range(reqs[name][1], layer, start, torch.from_numpy(k), torch.from_numpy(v))
    assert tm.device_bytes() == jm.device_bytes() > 0

    def reads():
        out = []
        for name, layer, start, n in writes + [("a", 1, 0, 96)]:
            jk, jv = jm.get_range(reqs[name][0], layer, start, n)
            tk, tv = tm.get_range(reqs[name][1], layer, start, n)
            out.append((tk, tv, jk, jv))
        return out

    def check():
        for tk, tv, jk, jv in reads():
            for got, want in ((tk, jk), (tv, jv)):
                if quantized:  # the same codes times scales within an ulp
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=2 ** -22, atol=0)
                else:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    check()
    # the raw storage agrees too: values and int8 codes equal; the scales
    # within one float32 ulp (XLA compiles the JAX manager's absmax / 127
    # under jit into a product with 1 / 127; the port divides, as the eager
    # JAX quantize_kv_block does)
    for i, (got, want) in enumerate(zip(tm.cache, jm.cache)):
        if want is None:
            continue
        if i < 2:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -23, atol=0)
    tm.free_layer(0)
    jm.free_layer(0)
    check()
    tm.free(reqs["a"][1])
    jm.free(reqs["a"][0])
    assert tm.active_requests() == jm.active_requests() == ["b"]
    assert not tm.cache.k[:, 0].any() and tm.cache.k[:, 1].any()
    assert tm.allocate_slots(reqs["a"][1]) == jm.allocate_slots(reqs["a"][0]) == 0
    before = [x.clone() for x in tm.cache if x is not None]
    # offload / restore on the port only: the JAX manager's restore fails on
    # its CPU backend (a pinned_host buffer put back under a device
    # sharding), so the JAX cache stays where it is and the port's restored
    # cache is held against it
    tm.offload_to_host()
    assert tm.device_bytes() == 0
    tm.restore_from_host()
    assert all(torch.equal(a, b) for a, b in zip(before, [x for x in tm.cache if x is not None]))
    check()
    tm.clear()
    jm.clear()
    assert tm.device_bytes() == jm.device_bytes() == 0


def test_config_round_trips():
    """The port's to_dict loads in both packages; the JAX package's
    to_dict (its TPU-only keys included) loads in the port; every field the
    two share agrees; unknown keys raise KeyError; hard-wired keys and a
    multi-device parallel section raise."""
    for jcfg, tcfg in ((jconfig.EngineConfig(), tconfig.EngineConfig()),
                       (jconfig.tiny_test_config(), tconfig.tiny_test_config())):
        tcfg.runtime.decode_mode = ttypes.DecodeMode.PER_BLOCK
        jcfg.runtime.decode_mode = jtypes.DecodeMode.PER_BLOCK
        tcfg.model_path, jcfg.model_path = "ckpt", "ckpt"
        td = tcfg.to_dict()
        assert tconfig.EngineConfig.from_dict(td) == tcfg
        from_port = jconfig.EngineConfig.from_dict(td).to_dict()
        from_jax = tconfig.EngineConfig.from_dict(jcfg.to_dict())
        assert from_jax == tcfg
        jd = jcfg.to_dict()
        for section in ("model", "quant", "runtime"):
            for k, v in td[section].items():
                assert jd[section][k] == v == from_port[section][k], (section, k)
        assert td["model_path"] == jd["model_path"]
    d = tconfig.EngineConfig().to_dict()
    d["runtime"]["streaming_mode"] = "true_streaming"
    assert tconfig.EngineConfig.from_dict(d).runtime.streaming_mode \
        == ttypes.StreamingMode.TRUE_STREAMING
    for section, key, value, exc in (("runtime", "bogus", 1, KeyError),
                                     ("model", "qk_norm", False, ValueError),
                                     ("parallel", "tp", 2, NotImplementedError),
                                     ("parallel", "bogus", 1, KeyError)):
        bad = tconfig.EngineConfig().to_dict()
        bad.setdefault(section, {})[key] = value
        with pytest.raises(exc):
            tconfig.EngineConfig.from_dict(bad)
    with pytest.raises(KeyError):
        jconfig.EngineConfig.from_dict({"runtime": {"bogus": 1}})


def test_config_from_json(tmp_path):
    p = tmp_path / "cfg.json"
    import json
    json.dump(jconfig.tiny_test_config().to_dict(), open(p, "w"))
    assert tconfig.EngineConfig.from_json(p) == tconfig.tiny_test_config()


def test_default_entry_points_raise_without_a_card():
    """The pipeline and the KV manager default to device="cuda" and raise
    without a card; no silent fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    _, tspec = _spec_pair(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortPipeline(tconfig.tiny_test_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmanager.KVCacheManager(tspec)
