"""The port's CFG pipeline (`pipeline/self_forcing_cfg.py`) against the JAX
package's `CausalDiffusionPipeline`, at tiny_test_config sizes in float32
on the CPU: the cond / uncond pair as one batched forward over a 2B cache,
UniPC and DPM++, the guided flow, the t=0 re-run after each block.

Both pipelines start from the same parameters and a stand-in text encoder
with the same features; the port's `_draw_noise` is given the JAX draw
(`jax.random.key(seed)` split once). Latents 1e-4 (tests/test_torch_semi_ar.py's
TOL: O(1) latents through a few forwards of float32 sums in other orders).
"""
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.pipeline.self_forcing_cfg import CausalDiffusionPipeline as JaxCFG
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.pipeline.self_forcing_cfg import CausalDiffusionPipeline as PortCFG
from inferix_tpu_torch.utils.params import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 4
FRAMES = 2


def _features(prompts, text_len=16, text_dim=64):
    """A stand-in text encoder: features seeded by each prompt."""
    return np.concatenate([
        (np.random.default_rng(zlib.crc32(p.encode())).standard_normal((1, text_len, text_dim))
         * 0.5).astype(np.float32) for p in prompts])


def _jax_noise(seed, shape):
    _, nk = jax.random.split(jax.random.key(seed))
    return torch.from_numpy(np.array(jax.random.normal(nk, shape)))


def _pair(solver, encoder=True):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    jpipe = JaxCFG(jcfg, params=jp, num_sampling_steps=STEPS, sample_solver=solver,
                   text_encoder=(lambda p: jnp.asarray(_features(p))) if encoder else None)
    tpipe = PortCFG(tcfg, params=tp, num_sampling_steps=STEPS, sample_solver=solver,
                    text_encoder=(lambda p: torch.from_numpy(_features(p))) if encoder else None,
                    dtype=torch.float32, device="cpu")
    tpipe._draw_noise = _jax_noise
    return jpipe, tpipe


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_cfg_latents_match_jax(solver):
    jpipe, tpipe = _pair(solver)
    kw = dict(negative_prompts=["blurry"], num_frames=FRAMES, seed=3)
    want = jpipe.run_text_to_video(["a red fox"], **kw)
    got = tpipe.run_text_to_video(["a red fox"], **kw)
    assert tuple(got.shape) == (1, FRAMES, 8, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the default guidance is max(runtime.guidance_scale, 5)
    np.testing.assert_array_equal(
        tpipe.run_text_to_video(["a red fox"], guidance_scale=5.0, **kw).numpy(), got.numpy())


def test_guidance_matters():
    """Guidance 5 against guidance 0 (the unconditional stream alone): the
    latents differ, and the negative prompt only matters with guidance."""
    _, tpipe = _pair("unipc")
    kw = dict(num_frames=FRAMES, seed=1)
    g5 = tpipe.run_text_to_video(["a red fox"], guidance_scale=5.0, **kw)
    g0 = tpipe.run_text_to_video(["a red fox"], guidance_scale=0.0, **kw)
    assert (g5 - g0).abs().max() > 1e-3
    neg = tpipe.run_text_to_video(["a red fox"], negative_prompts=["a cat"],
                                  guidance_scale=0.0, **kw)
    assert not torch.allclose(neg, g0)  # guidance 0 follows the negative stream


def test_no_text_encoder_warns_and_guidance_is_a_no_op():
    jpipe, tpipe = _pair("unipc", encoder=False)
    tpipe.setup()
    with pytest.warns(UserWarning, match="no text encoder"):
        a = tpipe.run_text_to_video(["x"], num_frames=1, guidance_scale=5.0, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = tpipe.run_text_to_video(["x"], num_frames=1, guidance_scale=0.0, seed=0)
        want = jpipe.run_text_to_video(["x"], num_frames=1, guidance_scale=5.0, seed=0)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), **TOL)


def test_unknown_solver_and_frames():
    with pytest.raises(ValueError, match="sample_solver"):
        PortCFG(tiny_test_config(), sample_solver="euler", device="cpu")
    _, tpipe = _pair("unipc")
    tcfg = tpipe.config
    tcfg.model.num_frame_per_block = 2
    with pytest.raises(ValueError, match="divisible"):
        tpipe.run_text_to_video(["a"], num_frames=3)
