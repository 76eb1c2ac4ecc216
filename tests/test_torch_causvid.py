"""The port's CausVid rollouts (`pipeline/causvid.py`) against the JAX
package's, at tiny_test_config sizes with the tiny VAE of
tests/test_pipeline.py, float32 on the CPU: a fresh cache a segment, the
AFTER_ALL decode, the boundary frame re-encoded through the VAE and put
before the last overlap - 1 latents, the overlap's pixels trimmed.

Both pipelines start from the same parameters, VAE weights and stand-in
text features, and the port draws its noise through `_draw_noise`, given
the JAX pipeline's draws (as in tests/test_torch_pipeline.py). Pixels 1e-4
(that file's DECODE_TOL).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.models.wan.vae import CausalVAE as JaxVAE
from inferix_tpu.models.wan.vae import VAEConfig as JaxVAEConfig
from inferix_tpu.pipeline import causvid as jcausvid
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.models.wan.vae import CausalVAE as PortVAE
from inferix_tpu_torch.models.wan.vae import VAEConfig as PortVAEConfig
from inferix_tpu_torch.pipeline import causvid as tcausvid
from inferix_tpu_torch.utils.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1,
           temperal_downsample=(True, True))


def _features(prompts, text_len=16, text_dim=64):
    rng = np.random.default_rng(zlib.crc32(prompts[0].encode()))
    return (rng.standard_normal((1, text_len, text_dim)) * 0.5).astype(np.float32)


def _jax_draws(n_steps):
    """The port's `_draw_noise` with the JAX pipeline's draws (one block a
    frame at tiny_test_config)."""
    def draw(seed, shape):
        rng, nkey = jax.random.split(jax.random.key(seed))
        noise = torch.from_numpy(np.array(jax.random.normal(nkey, shape)))
        blk = (shape[0], 1) + tuple(shape[2:])
        renoise = []
        for _ in range(shape[1]):
            rng, step_rng = jax.random.split(rng)
            keys = jax.random.split(step_rng, n_steps)
            renoise.append([torch.from_numpy(np.array(jax.random.normal(keys[i], blk)))
                            for i in range(n_steps - 1)])
        return noise, None, renoise
    return draw


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    assert tcausvid.causvid_config().runtime.overlap_frames == \
        jcausvid.causvid_config().runtime.overlap_frames == 3
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jvae = JaxVAE(JaxVAEConfig(**VAE), key=jax.random.key(9))
    jpipe = jcausvid.CausVidPipeline(
        jcfg, params=jp, vae=jvae, dtype=jnp.float32,
        text_encoder=lambda p: jnp.asarray(_features(p)))
    tpipe = tcausvid.CausVidPipeline(
        tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32),
        vae=PortVAE(PortVAEConfig(**VAE),
                    params_from_numpy(jax.tree.map(np.asarray, jvae.params), "cpu",
                                      torch.float32), dtype=torch.float32, device="cpu"),
        text_encoder=lambda p: torch.from_numpy(_features(p)),
        dtype=torch.float32, device="cpu")
    tpipe._draw_noise = _jax_draws(len(tcfg.runtime.denoising_step_list))
    return jpipe, tpipe


@pytest.mark.parametrize("overlap", [3, 1])
def test_rollouts_match_jax(pipes, overlap):
    """Two rollouts, one prompt a segment: each segment's pixels against
    the JAX pipeline's, the trimmed lengths, and segment 2 starting from
    the re-encoded boundary frame."""
    jpipe, tpipe = pipes
    starts = []
    real = tpipe._encode_start_latents
    tpipe._encode_start_latents = lambda *a: starts.append(real(*a)) or starts[-1]
    try:
        want = jpipe.run_rollouts(["a red fox", "a blue bird"], num_rollouts=2,
                                  num_overlap_frames=overlap, seed=5)
        got = tpipe.run_rollouts(["a red fox", "a blue bird"], num_rollouts=2,
                                 num_overlap_frames=overlap, seed=5)
    finally:
        del tpipe._encode_start_latents
    # 4 latent frames -> 13 pixel frames; the first segment loses its
    # overlap's 4 (overlap - 1) + 1 pixel frames
    assert [v.shape[1] for v in got] == [13 - (4 * (overlap - 1) + 1), 13]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert len(starts) == 1 and starts[0].shape[1] == overlap
    assert tpipe.kv_manager.active_requests() == []


def test_encode_start_latents(pipes):
    """The boundary frame (in [0, 1], mapped back to [-1, 1]) through the
    encoder, then the last overlap - 1 latents, against the JAX helper."""
    jpipe, tpipe = pipes
    jpipe.setup()
    tpipe.setup()
    rng = np.random.default_rng(3)
    video = rng.uniform(0, 1, (1, 13, 32, 32, 3)).astype(np.float32)
    lat = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
    want = jpipe._encode_start_latents(jnp.asarray(video), jnp.asarray(lat), 3)
    got = tpipe._encode_start_latents(torch.from_numpy(video), torch.from_numpy(lat), 3)
    assert tuple(got.shape) == (1, 3, 8, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[:, 1:].numpy(), lat[:, -2:])


def test_rollouts_need_a_vae():
    cfg = tiny_test_config()
    from inferix_tpu_torch.core.types import DecodeMode
    cfg.runtime.decode_mode = DecodeMode.NO_DECODE
    pipe = tcausvid.CausVidPipeline(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="need a VAE"):
        pipe.run_rollouts("a", num_rollouts=1)
