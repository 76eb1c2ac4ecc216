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
