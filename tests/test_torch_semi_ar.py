"""The port's semi-AR generator against `inferix_tpu.pipeline.semi_ar`, at
tiny_test_config sizes in float32 on the CPU.

Both start from the same parameters and numpy inputs, and the port is handed
the renoise the JAX generator draws (jax.random and torch generators give
different numbers). Tolerance 1e-4 absolute and relative: the latents are
O(1) and come out of 2 blocks x (2 denoise steps + the context forward) of a
2-layer DiT whose float32 sums the two frameworks take in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCKS = 2


@pytest.fixture(scope="module", params=["rerun", "last_step"])
def pair(request):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jcfg.runtime.context_mode = tcfg.runtime.context_mode = request.param
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jgen = JaxGenerator(jcfg, jp, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                   torch.float32),
                           dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    m, r = jcfg.model, jcfg.runtime
    ctx = rng.standard_normal((1, m.text_len, m.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, BLOCKS, r.latent_height, r.latent_width,
                                 r.latent_channels)).astype(np.float32)
    return (jgen, jgen.encode_text_context(jnp.asarray(ctx)), tgen,
            tgen.encode_text_context(torch.from_numpy(ctx)), noise)


def _jax_renoise(step_rng, n_steps, shape):
    """The renoise `_denoise_steps_impl` draws for one block: one key per
    step from split(step_rng, n_steps), all steps but the last used."""
    keys = jax.random.split(step_rng, n_steps)
    return [torch.from_numpy(np.array(jax.random.normal(keys[i], shape, jnp.float32)))
            for i in range(n_steps - 1)]


def test_text_context(pair):
    jgen, jx, tgen, tx, _ = pair
    np.testing.assert_allclose(tx.k.numpy(), np.asarray(jx.k), **TOL)
    np.testing.assert_allclose(tx.v.numpy(), np.asarray(jx.v), **TOL)


def test_blocks_and_cache_after_each(pair):
    """denoise_block block by block, with generate's key schedule: x0 and
    the whole KV cache after each block."""
    jgen, jx, tgen, tx, noise = pair
    n = len(jgen.denoising_steps)
    assert tgen.denoising_steps == jgen.denoising_steps
    rng = jax.random.key(2)
    jc, tc = jgen.init_cache(), tgen.init_cache()
    fpb = jgen.cfg.model.num_frame_per_block
    for bi in range(BLOCKS):
        rng, step_rng = jax.random.split(rng)
        blk = noise[:, bi * fpb:(bi + 1) * fpb]
        jx0, jc = jgen.denoise_block(jc, jx, jnp.asarray(blk), step_rng, bi * fpb)
        tx0, tc = tgen.denoise_block(tc, tx, torch.from_numpy(blk), bi * fpb,
                                     renoise=_jax_renoise(step_rng, n, blk.shape))
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_generate(pair):
    """The whole 2-block clip through generate: latents and final cache."""
    jgen, jx, tgen, tx, noise = pair
    n = len(jgen.denoising_steps)
    fpb = jgen.cfg.model.num_frame_per_block
    rng = jax.random.key(3)
    jlat, jc = jgen.generate(jnp.asarray(noise), jx, rng)
    renoise = []
    for bi in range(BLOCKS):
        rng, step_rng = jax.random.split(rng)
        renoise.append(_jax_renoise(step_rng, n, (1, fpb) + noise.shape[2:]))
    seen = []
    tlat, tc = tgen.generate(torch.from_numpy(noise), tx, renoise=renoise,
                             block_callback=lambda x0, bi: seen.append(bi))
    assert seen == list(range(BLOCKS))
    assert tlat.shape == noise.shape
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_generate_after_initial_latent(pair):
    """A clean initial_latent prefix is written into the cache first
    (cache_context_block), then one block is generated after it."""
    jgen, jx, tgen, tx, noise = pair
    n = len(jgen.denoising_steps)
    rng = jax.random.key(4)
    init = noise[:, :1] * 0.5
    jlat, jc = jgen.generate(jnp.asarray(noise[:, 1:]), jx, rng,
                             initial_latent=jnp.asarray(init))
    _, step_rng = jax.random.split(rng)
    tlat, tc = tgen.generate(torch.from_numpy(noise[:, 1:]), tx,
                             initial_latent=torch.from_numpy(init),
                             renoise=[_jax_renoise(step_rng, n, init.shape)])
    assert tlat.shape == noise.shape
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_generate_draws_from_its_generator(pair):
    """Without handed-in renoise the port draws from the torch.Generator:
    the same seed gives the same clip, another seed another one."""
    _, _, tgen, tx, noise = pair
    runs = [tgen.generate(torch.from_numpy(noise), tx,
                          generator=torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# --- the int8 and fp8 KV caches, B=2, and the rolling window with sink ---

def _quant_cfg(cfg, variant, mode):
    """The tiny config with one of this slice's caches: int8 (also at B=2
    and in the rolling window), fp8, all with float32 weights."""
    cfg.runtime.context_mode = mode
    q = cfg.quant
    q.enabled, q.quantize_kv_cache = True, True
    q.kv_cache_dtype = "fp8" if variant == "fp8" else "int8"
    if variant == "int8_b2":
        cfg.runtime.batch_size = 2
    if variant == "window":
        # 2-frame blocks through a 5-frame window with 1 sink frame: the
        # 4-frame ring wraps in the middle of the third block
        m = cfg.model
        m.num_frame_per_block, m.local_attn_size, m.sink_size = 2, 5, 1
    return cfg


VARIANTS = {"int8": 2, "fp8": 2, "int8_b2": 2, "window": 4}  # variant -> blocks


@pytest.fixture(scope="module", params=[(v, m) for v in VARIANTS
                                        for m in ("rerun", "last_step")],
                ids=lambda p: "-".join(p))
def qpair(request):
    variant, mode = request.param
    jcfg = _quant_cfg(jax_tiny_config(), variant, mode)
    tcfg = _quant_cfg(tiny_test_config(), variant, mode)
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jgen = JaxGenerator(jcfg, jp, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                   torch.float32),
                           dtype=torch.float32, device="cpu")
    b = jcfg.runtime.batch_size
    m, r = jcfg.model, jcfg.runtime
    frames = VARIANTS[variant] * m.num_frame_per_block
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((b, m.text_len, m.text_dim)).astype(np.float32)
    noise = rng.standard_normal((b, frames, r.latent_height, r.latent_width,
                                 r.latent_channels)).astype(np.float32)
    return (variant, jgen, jgen.encode_text_context(jnp.asarray(ctx)), tgen,
            tgen.encode_text_context(torch.from_numpy(ctx)), noise)


FLIP_SHARE = 1e-3  # at most this share of cache values a step apart


def _assert_cache_close(tc, jc):
    """Every field of the port's cache against the JAX one, as values: int8
    codes times their scales, e4m3 values cast to float32. The two write
    float32 K/V that differ in their last bits (other summation orders), so
    a value at a rounding boundary of the int8 code or of e4m3 may round the
    other way: one quantization step (one code, or one e4m3 ulp, 2^-3 of
    the value) in at most FLIP_SHARE of the values. All others, and the
    scales, agree within TOL."""
    assert (tc.k_scale is None) == (jc.k_scale is None)
    quant = tc.k_scale is not None
    for name in ("k", "v"):
        t, j = getattr(tc, name).float().numpy(), np.asarray(getattr(jc, name), np.float32)
        if quant:
            ts = getattr(tc, name + "_scale").numpy()
            js = np.asarray(getattr(jc, name + "_scale"))
            np.testing.assert_allclose(ts, js, **TOL)
            t, j = t * ts[..., None], j * js[..., None]
            step = np.broadcast_to(js[..., None], t.shape)
        else:
            step = np.maximum(np.abs(t), np.abs(j)) * 2.0 ** -3 + 2.0 ** -9
        err = np.abs(t - j)
        off = err > TOL["atol"] + TOL["rtol"] * np.abs(j)
        assert off.mean() <= FLIP_SHARE, (name, int(off.sum()))
        assert (err[off] <= step[off] * (1 + 1e-4) + 1e-6).all(), (name, err[off].max())


def test_quant_cache_blocks_and_cache_after_each(qpair):
    """denoise_block block by block with generate's key schedule: x0 and the
    whole cache after each block (after the ring wraps, for the window)."""
    variant, jgen, jx, tgen, tx, noise = qpair
    spec = tgen.statics.spec
    assert spec.quantized == (variant != "fp8")
    assert spec.ring == (variant == "window")
    n = len(jgen.denoising_steps)
    rng = jax.random.key(2)
    jc, tc = jgen.init_cache(), tgen.init_cache()
    fpb = jgen.cfg.model.num_frame_per_block
    for bi in range(noise.shape[1] // fpb):
        rng, step_rng = jax.random.split(rng)
        blk = noise[:, bi * fpb:(bi + 1) * fpb]
        jx0, jc = jgen.denoise_block(jc, jx, jnp.asarray(blk), step_rng, bi * fpb)
        tx0, tc = tgen.denoise_block(tc, tx, torch.from_numpy(blk), bi * fpb,
                                     renoise=_jax_renoise(step_rng, n, blk.shape))
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), **TOL)
        _assert_cache_close(tc, jc)
    if variant == "window":
        assert (bi + 1) * fpb * tgen.frame_seq > spec.max_tokens  # the ring wrapped


def test_quant_cache_generate(qpair):
    """The whole clip through generate: latents and final cache."""
    variant, jgen, jx, tgen, tx, noise = qpair
    n = len(jgen.denoising_steps)
    fpb = jgen.cfg.model.num_frame_per_block
    rng = jax.random.key(3)
    jlat, jc = jgen.generate(jnp.asarray(noise), jx, rng)
    renoise = []
    for _ in range(noise.shape[1] // fpb):
        rng, step_rng = jax.random.split(rng)
        renoise.append(_jax_renoise(step_rng, n, (noise.shape[0], fpb) + noise.shape[2:]))
    tlat, tc = tgen.generate(torch.from_numpy(noise), tx, renoise=renoise)
    assert tlat.shape == noise.shape
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    _assert_cache_close(tc, jc)
