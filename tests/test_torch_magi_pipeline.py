"""The port's MAGI pipeline (`inferix_tpu_torch.pipeline.magi`) against the
JAX package's, float32, on the CPU, with the JAX noise injected.

Both packages walk `tiny_magi_config` (2 layers, width 128) over 8x8
latents, 3 chunks of 2 frames, window 2, 4 steps (8 for the distilled
cases), from one weight tree (the
JAX initialiser's, its LayerNorms and biases moved off zero, through
`params_from_numpy`), one caption with a 5-token prefix mask; the port's
`_draw_noise` returns the JAX walk's draw (`jax.random.split` of the seed's
key, then `normal`), so both walks start from the same latents.

Tolerances, each with its reason:
- float32 throughout: each forward matches the JAX forward to ~1e-5
  relative (tests/test_torch_magi.py, its TOL); a walk adds 4 Euler steps
  a chunk, the prefix and the clean re-forwards through the cache, and the
  3-CFG combination multiplies the cond / uncond difference by up to
  text_scale + 1 = 8.5: chunks within WALK_RTOL = 1e-4 in norm (measured
  6e-7 to 1e-5);
- the int8 window cache: a code next to a rounding tie flips on the 1e-6
  difference of the two sides' K/V, and the plain int8-KV version rounds
  p * v_scale to bf16 (tests/test_torch_magi.py, INT8_KV_RTOL): chunks
  within INT8_WALK_RTOL = 2e-2 in norm (measured ~2e-3);
- the e4m3 cache (`kv_dtype`): a forward is held to E4M3_RTOL = 1e-3
  (tests/test_torch_magi.py: a K/V value that the float32 differences move
  across an e4m3 rounding boundary moves by an e4m3 step), and the 3-CFG
  combination multiplies the cond / uncond difference by up to 8.5:
  chunks within E4M3_WALK_RTOL = 1e-2 in norm (measured 2e-6 to 1.7e-3);
- the port against itself: "scan" is the per-chunk loop, bit-equal;
  "whole" sums other GEMM shapes in float32 (SELF_RTOL = 1e-5 in norm);
  a resumed walk is bit-equal to the walk without the break.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.magi import dit as jdit
from inferix_tpu.models.magi import vae as jvae
from inferix_tpu.pipeline import magi as jpipe
from inferix_tpu.profiling.profiler import InferixProfiler as JaxProfiler
from inferix_tpu.profiling.profiler import ProfilingConfig as JaxProfilingConfig
from inferix_tpu_torch.models.magi import dit as tdit
from inferix_tpu_torch.models.magi.vae import ViTVAE, ViTVAEConfig
from inferix_tpu_torch.pipeline import magi as tpipe
from inferix_tpu_torch.profiling.profiler import InferixProfiler, ProfilingConfig
from inferix_tpu_torch.utils.params import params_from_numpy
from inferix_tpu_torch.utils.state_checkpoint import (load_generation_state,
                                                      save_generation_state)

from test_torch_magi import _perturbed_init, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK_RTOL = 1e-4
INT8_WALK_RTOL = 2e-2
E4M3_WALK_RTOL = 1e-2
SELF_RTOL = 1e-5
LAT = 8
CHUNKS = 3
CAPTION_TOKENS = 5


@pytest.fixture(scope="module")
def trees():
    """(JAX config, port config, JAX tree, port tree, caption, mask)."""
    jcfg = jdit.tiny_magi_config()
    tcfg = tdit.MagiModelConfig(**dataclasses.asdict(jcfg))
    npt = _perturbed_init(jcfg, 11)
    rng = np.random.default_rng(12)
    cap = rng.standard_normal((1, jcfg.caption_max_length, jcfg.caption_channels)
                              ).astype(np.float32)
    mask = np.zeros((1, jcfg.caption_max_length), np.int32)
    mask[:, :CAPTION_TOKENS] = 1
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, npt),
            params_from_numpy(npt, "cpu", torch.float32), cap, mask)


def jax_noise(seed, shape):
    """The JAX walk's draw: `normal` over the second half of the seed key's split."""
    _, nkey = jax.random.split(jax.random.key(seed))
    return np.asarray(jax.random.normal(nkey, shape))


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(tpipe.MagiPipeline, "_draw_noise",
                        lambda self, g, shape: torch.tensor(jax_noise(self.rt.seed, shape)))


def _runtime(**kw):
    base = dict(num_steps=4, window_size=2, chunk_width=2)
    base.update(kw)
    return jpipe.MagiRuntimeConfig(**base), tpipe.MagiRuntimeConfig(**base)


def _port_pipe(trees, rt, cls=tpipe.MagiPipeline, **kw):
    _, tcfg, _, tp, _, _ = trees
    return cls(tcfg, rt, params=tp, latent_h=LAT, latent_w=LAT, max_chunks=6,
               dtype=torch.float32, device="cpu", **kw)


def _jax_pipe(trees, rt, cls=jpipe.MagiPipeline, **kw):
    jcfg, _, jp, _, _, _ = trees
    return cls(jcfg, rt, params=jp, latent_h=LAT, latent_w=LAT, max_chunks=6,
               dtype=jnp.float32, **kw)


def _walk(pipe, trees, prefix=None, **kw):
    cap, mask = trees[4], trees[5]
    if isinstance(pipe, jpipe.MagiPipeline):
        cap, mask = jnp.asarray(cap), jnp.asarray(mask)
        prefix = None if prefix is None else jnp.asarray(prefix)
    else:
        cap, mask = torch.from_numpy(cap), torch.from_numpy(mask)
        prefix = None if prefix is None else torch.from_numpy(prefix)
    return [(i, np.array(c)) for i, c in
            pipe.generate_chunks(cap, mask, CHUNKS, prefix_latents=prefix, **kw)]


def _prefix(cfg):
    return np.random.default_rng(13).standard_normal(
        (1, 2, LAT, LAT, cfg.latent_channels)).astype(np.float32)


CASES = {
    "cfg1": dict(cfg_number=1),
    "cfg2": dict(cfg_number=2),
    "cfg3": dict(cfg_number=3),
    # 8 steps: 4 steps' t values (0, 0.0217, 0.1, 0.3, 1) never pass the
    # re-mix threshold 0.3
    "distill": dict(cfg_number=1, distill=True, num_steps=8),
    "distill_cfg3": dict(cfg_number=3, distill=True, num_steps=8),
    "prefix_cfg3": dict(cfg_number=3),
    "quantize_kv": dict(cfg_number=3, quantize_kv=True),
    "kv_e4m3": dict(cfg_number=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_chunks_matches_jax(trees, injected, case):
    """Every yielded chunk: its index and latents against the JAX walk's;
    the cfg1 case with the profiler on, its step and chunk records against
    the JAX profiler's."""
    jrt, trt = _runtime(**CASES[case])
    prefix = _prefix(trees[0]) if case.startswith("prefix") else None
    prof = case == "cfg1"
    jprof = JaxProfiler(JaxProfilingConfig(enabled=True)) if prof else None
    tprof = InferixProfiler(ProfilingConfig(enabled=True)) if prof else None
    e4m3 = case == "kv_e4m3"
    jpipe_ = _jax_pipe(trees, jrt, profiler=jprof, kv_dtype=jnp.float8_e4m3fn if e4m3 else None)
    tpipe_ = _port_pipe(trees, trt, profiler=tprof,
                        kv_dtype=torch.float8_e4m3fn if e4m3 else None)
    want = _walk(jpipe_, trees, prefix)
    got = _walk(tpipe_, trees, prefix)
    assert [i for i, _ in got] == [i for i, _ in want] == list(
        range(CHUNKS - (prefix is not None)))
    rtol = {"quantize_kv": INT8_WALK_RTOL, "kv_e4m3": E4M3_WALK_RTOL}.get(case, WALK_RTOL)
    for (i, g), (_, w) in zip(got, want):
        assert g.shape == w.shape == (1, 2, LAT, LAT, trees[0].latent_channels)
        err = _rel(g, w)
        print(f"{case} chunk {i}: rel err {err:.3g}")
        assert np.isfinite(g).all() and err <= rtol, (case, i, err)
    if prof:
        fields = ("step", "timestep", "block_size")
        assert [tuple(r[k] for k in fields) for r in tprof.diffusion_steps] == \
            [tuple(r[k] for k in fields) for r in jprof.diffusion_steps]
        assert [(r["block"], r["frames"]) for r in tprof.blocks] == \
            [(r["block"], r["frames"]) for r in jprof.blocks] == [(i, 2) for i in range(CHUNKS)]
        assert all(r["time_ms"] > 0 for r in tprof.diffusion_steps + tprof.blocks)


def test_distill_remix_runs(trees, injected, monkeypatch):
    """The distilled walk takes the nearly-clean re-mix: some window forward
    carries one chunk more than its window (the prefix-free copy)."""
    _, trt = _runtime(cfg_number=1, distill=True, num_steps=8, window_dispatch="whole")
    pipe = _port_pipe(trees, trt)
    widths = []
    real = tpipe.magi_forward

    def spy(params, statics, rope, x_window, *a, **k):
        widths.append(x_window.shape[1] // 2)
        return real(params, statics, rope, x_window, *a, **k)

    monkeypatch.setattr(tpipe, "magi_forward", spy)
    _walk(pipe, trees)
    sched_widths = []
    from inferix_tpu_torch.models.magi.scheduler import ChunkSchedule, MagiScheduleConfig
    sched = ChunkSchedule(MagiScheduleConfig(chunk_num=CHUNKS, chunk_width=2, window_size=2,
                                             num_steps=8))
    for step in range(sched.total_forward_steps):
        c0, c1, _, _ = sched.window(step)
        sched_widths.append(c1 - c0 + sched.fwd_extra_1st_chunk(step))
    assert len(widths) == len(sched_widths)
    extra = [w - s for w, s in zip(widths, sched_widths)]
    assert set(extra) <= {0, 1} and 1 in extra and 0 in extra


@pytest.mark.parametrize("cfg_number", [1, 3])
def test_window_dispatches_agree(trees, injected, cfg_number):
    """"scan" bit-equal to "per_chunk" (both the per-chunk loop here),
    "whole" within SELF_RTOL, with the int8 cache for cfg 3."""
    out = {}
    for disp in ("per_chunk", "scan", "whole"):
        _, trt = _runtime(cfg_number=cfg_number, window_dispatch=disp,
                          quantize_kv=cfg_number == 3)
        out[disp] = _walk(_port_pipe(trees, trt), trees)
    for (_, a), (_, b) in zip(out["scan"], out["per_chunk"]):
        assert np.array_equal(a, b)
    tol = INT8_WALK_RTOL if cfg_number == 3 else SELF_RTOL
    for (_, a), (_, b) in zip(out["whole"], out["per_chunk"]):
        assert _rel(a, b) <= tol


def test_resume_is_bit_equal(trees, injected, tmp_path):
    """The walk's state after step 3, cloned by the callback, saved with
    `save_generation_state` and read back: the resumed walk yields the
    remaining chunks bit-equal to the walk without the break."""
    _, trt = _runtime(cfg_number=3, quantize_kv=True)
    full = _walk(_port_pipe(trees, trt), trees)
    states = {}

    def keep(state, step):
        states[step] = {"x": state["x"].clone(),
                        "cache": {k: v.clone() for k, v in state["cache"].items()},
                        "step": state["step"],
                        "chunk_denoise_count": state["chunk_denoise_count"].copy()}

    _walk(_port_pipe(trees, trt), trees, state_callback=keep)
    path = save_generation_state(str(tmp_path / "magi.npz"), **states[3])
    state = load_generation_state(path, device="cpu")
    rest = _walk(_port_pipe(trees, trt), trees, resume_state=state)
    done_before = sum(1 for i, _ in full if i not in [j for j, _ in rest])
    assert len(rest) > 0 and len(rest) + done_before == len(full)
    for (i, a), (j, b) in zip(rest, full[done_before:]):
        assert i == j and np.array_equal(a, b)


def test_video_pipeline_decodes_each_chunk(trees, injected):
    """`MagiVideoPipeline.generate_video` with a tiny ViT-VAE (z 16, the
    DiT's latent channels; the JAX initialiser's tree): the pixels and the
    callback's indices against the JAX pipeline's."""
    vcfg = dataclasses.replace(jvae.tiny_vitvae_config(), z_chans=16)
    vparams = jax.tree.map(np.asarray, jvae.init_vitvae_params(jax.random.key(3), vcfg))
    jv = jvae.ViTVAE(vcfg, params=jax.tree.map(jnp.asarray, vparams))
    tv = ViTVAE(ViTVAEConfig(**dataclasses.asdict(vcfg)),
                params=params_from_numpy(vparams, "cpu", torch.float32), device="cpu")
    jrt, trt = _runtime(cfg_number=3)
    seen = {"jax": [], "port": []}
    cap, mask = trees[4], trees[5]
    want = _jax_pipe(trees, jrt, jpipe.MagiVideoPipeline, vae=jv).generate_video(
        jnp.asarray(cap), jnp.asarray(mask), CHUNKS,
        chunk_callback=lambda px, i: seen["jax"].append(i))
    got = _port_pipe(trees, trt, tpipe.MagiVideoPipeline, vae=tv).generate_video(
        torch.from_numpy(cap), torch.from_numpy(mask), CHUNKS,
        chunk_callback=lambda px, i: seen["port"].append(i))
    assert got.shape == want.shape == (1, CHUNKS * 2 * 2, 32, 32, 3)
    assert seen["port"] == seen["jax"] == list(range(CHUNKS))
    err = _rel(got, want)
    assert err <= WALK_RTOL and float(got.abs().max()) <= 1.0, err


@pytest.mark.parametrize("name", ["4p5b", "4p5b_distill_quant", "24b"])
def test_magi_config_from_json(name):
    path = os.path.join(REPO, "examples", "configs", f"magi_{name}.json")
    jm, jr = jpipe.magi_config_from_json(path)
    tm, tr = tpipe.magi_config_from_json(path)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


@pytest.mark.parametrize("kw,vkw,match", [
    (dict(mesh=object()), {}, "A13"),
    ({}, dict(cp_strategy="cso"), "A13"),
    ({}, dict(cp_strategy="ulysses"), "A13"),
    ({}, dict(kv_head_major=True), "A14c"),
    ({}, dict(kv_alloc_pad=True), "A14c"),
    (dict(tile=True), {}, "A13"),
    (dict(decode_devices=["cuda:1"]), {}, "A13"),
])
def test_refusals(trees, kw, vkw, match):
    _, trt = _runtime(**vkw)
    cls = tpipe.MagiVideoPipeline if ("tile" in kw or "decode_devices" in kw) \
        else tpipe.MagiPipeline
    with pytest.raises(NotImplementedError, match=match):
        _port_pipe(trees, trt, cls, **kw)


def test_non_prefix_caption_mask_refused(trees):
    _, trt = _runtime()
    pipe = _port_pipe(trees, trt)
    cap, mask = trees[4], trees[5].copy()
    mask[0, 1] = 0
    with pytest.raises(ValueError, match="prefix mask"):
        next(pipe.generate_chunks(torch.from_numpy(cap), torch.from_numpy(mask), CHUNKS))


def test_cfg_scales_and_null_caption_match_jax(trees):
    jrt, trt = _runtime(cfg_number=3)
    jp, tp = _jax_pipe(trees, jrt), _port_pipe(trees, trt)
    t = np.array([0.0, 0.02, 0.0217, 0.05, 0.1, 0.2999, 0.3, 0.9, 0.9999])
    for a, b in zip(tp._cfg_scales(t), jp._cfg_scales(t)):
        assert np.array_equal(a, b)
    for a, b in zip(tp._null_caption(8), jp._null_caption(8)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tp._distill_dt_factor(2.0) is None
    _, trt12 = _runtime(cfg_number=1, distill=True, num_steps=12, window_size=4)
    assert tpipe.MagiPipeline._distill_dt_factor(
        type("P", (), {"rt": trt12})(), 2.0) == 4.0


def test_package_exports():
    import inferix_tpu_torch

    assert inferix_tpu_torch.MagiPipeline is tpipe.MagiPipeline
    assert inferix_tpu_torch.MagiVideoPipeline is tpipe.MagiVideoPipeline
