"""Continuous batching in the port (`pipeline/continuous.py`, the `[B]`
starts through `SemiARGenerator.denoise_block`, `dit_forward_inference` and
`rope_angles`), at tiny_test_config sizes in float32 on the CPU.

The JAX package's tests/test_continuous_batching.py, on the port: streams
at different positions advance in one batched step, and a stream admitted
next to a neighbour mid-run gives the latents of the same stream run alone
(bf16 cache, int8 cache, `last_step`, the ring window with a sink), at the
JAX tests' 2e-4. Then the `[B]`-start denoise step against the JAX one,
with the JAX per-slot draws handed in as renoise: latents and cache 1e-4
(tests/test_torch_semi_ar.py's TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.ops.rope import build_rope_tables as jax_rope_tables
from inferix_tpu.ops.rope import rope_angles as jax_rope_angles
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.kvcache.cache import valid_mask
from inferix_tpu_torch.ops.rope import build_rope_tables, rope_angles
from inferix_tpu_torch.pipeline.continuous import ContinuousBatcher
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import init_params, params_from_numpy

ISOLATION_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _batcher(cfg, params):
    gen = SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(gen)
    m = cfg.model
    b.set_conditioning(gen.encode_text_context(
        torch.zeros(cfg.runtime.batch_size, m.text_len, m.text_dim)))
    return b


def _params(cfg):
    return init_params(cfg.model, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)


def _outputs(b, rid):
    return torch.cat(b.streams[rid].outputs, dim=1)


def test_streams_advance_independently():
    cfg = tiny_test_config()
    cfg.runtime.batch_size = 3
    b = _batcher(cfg, _params(cfg))
    b.admit("a", num_frames=3, seed=1)
    assert [rid for rid, _ in b.step()] == ["a"]
    b.admit("b", num_frames=2, seed=2)
    assert sorted(rid for rid, _ in b.step()) == ["a", "b"]
    assert b.streams["a"].frames_done == 2 and b.streams["b"].frames_done == 1
    b.step()
    assert b.streams["a"].finished and b.streams["b"].finished
    assert b.step() == []
    a = b.retire("a")
    assert len(a.outputs) == 3 and all(o.shape == (1, 1, 8, 8, 16) for o in a.outputs)
    c = b.admit("c", num_frames=1, seed=3)
    assert 0 <= c.slot < b.max_streams  # the slot pool is not exhausted


def _isolation(cfg, solo_frames, other_frames, lead_steps):
    """The latents of stream x alone, and of x admitted after `other` has
    run lead_steps blocks in another slot."""
    params = _params(cfg)
    b1 = _batcher(cfg, params)
    b1.admit("x", num_frames=solo_frames, seed=7)
    for _ in range(solo_frames):
        b1.step()
    b2 = _batcher(cfg, params)
    b2.admit("other", num_frames=other_frames, seed=9)
    for _ in range(lead_steps):
        b2.step()
    b2.admit("x", num_frames=solo_frames, seed=7)
    for _ in range(solo_frames):
        b2.step()
    return _outputs(b1, "x"), _outputs(b2, "x")


def test_mid_run_admission_isolated():
    cfg = tiny_test_config()
    cfg.runtime.batch_size = 3
    solo, mixed = _isolation(cfg, 2, 4, 2)
    torch.testing.assert_close(mixed, solo, **ISOLATION_TOL)


def _int8_kv(cfg):
    cfg.runtime.batch_size = 2
    q = cfg.quant
    q.enabled, q.quantize_kv_cache, q.kv_cache_dtype = True, True, "int8"
    # float weights: the cache alone is quantized
    q.exclude = ("self_attn", "cross_attn", "ffn", "text_embedding", "head",
                 "patch_embedding", "time_")
    return cfg


def test_mid_run_admission_isolated_with_int8_kv():
    solo, mixed = _isolation(_int8_kv(tiny_test_config()), 2, 4, 2)
    torch.testing.assert_close(mixed, solo, **ISOLATION_TOL)


def test_last_step_context_mode():
    cfg = tiny_test_config()
    cfg.runtime.batch_size = 2
    cfg.runtime = dataclasses.replace(cfg.runtime, context_mode="last_step")
    b = _batcher(cfg, _params(cfg))
    b.admit("a", num_frames=2, seed=1)
    b.step()
    b.admit("b", num_frames=1, seed=2)
    b.step()
    assert b.streams["a"].finished and b.streams["b"].finished
    assert all(torch.isfinite(o).all() for o in b.retire("a").outputs)


def test_mid_run_admission_isolated_ring_window_int8():
    """The ring (a 3-frame window: sink 1 + 2) with int8 K/V and last_step:
    x wraps the ring at its own positions while its neighbour wraps at
    others, and matches its solo run."""
    cfg = _int8_kv(tiny_test_config())
    cfg.runtime.context_mode = "last_step"
    cfg.model.local_attn_size, cfg.model.sink_size = 2, 1
    solo, mixed = _isolation(cfg, 5, 7, 2)
    torch.testing.assert_close(mixed, solo, **ISOLATION_TOL)


def test_rope_angles_per_stream():
    jt, tt = jax_rope_tables(32, 64), build_rope_tables(32, 64, device="cpu")
    starts = np.array([0, 3, 7], np.int32)
    want = jax.vmap(lambda s0: jax_rope_angles(jt, 2, 4, 4, s0))(jnp.asarray(starts))
    got = rope_angles(tt, 2, 4, 4, torch.from_numpy(starts))
    assert tuple(got.shape) == (3, 32, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for i, s0 in enumerate(starts):
        assert torch.equal(got[i], rope_angles(tt, 2, 4, 4, int(s0)))
    mask = valid_mask(_spec(), torch.tensor([16, 48]), "cpu")
    assert mask.shape == (2, 96) and mask.sum(1).tolist() == [16, 48]


def _spec():
    from inferix_tpu_torch.models.wan.causal_dit import make_kv_spec
    return make_kv_spec(tiny_test_config().model, 2, 8, 8)


def _jax_slot_renoise(keys, n_steps, shape):
    """JAX semi_ar.py's per-slot draws: step i of slot b from
    split(keys[b], n_steps)[i]."""
    per_slot = [jax.random.split(k, n_steps) for k in keys]
    return [torch.from_numpy(np.array(jnp.stack(
        [jax.random.normal(s[i], shape, jnp.float32) for s in per_slot])))
        for i in range(n_steps - 1)]


@pytest.mark.parametrize("context_mode", ["rerun", "last_step"])
def test_denoise_block_per_stream_starts_against_jax(context_mode):
    """Three batched steps at starts [0, 0], [1, 0] and [2, 1] (slot 1
    restarts at 0 after its first block): x0 and the whole cache after each
    against the JAX generator fed the same [B] starts and per-slot keys."""
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    for c in (jcfg, tcfg):
        c.runtime.batch_size = 2
        c.runtime.context_mode = context_mode
    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jgen = JaxGenerator(jcfg, jp, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                   torch.float32),
                           dtype=torch.float32, device="cpu")
    m = jcfg.model
    ctx = np.random.default_rng(0).standard_normal((2, m.text_len, m.text_dim)).astype(np.float32)
    jx, tx = jgen.encode_text_context(jnp.asarray(ctx)), tgen.encode_text_context(
        torch.from_numpy(ctx))
    jc, tc = jgen.init_cache(), tgen.init_cache()
    n_steps = len(tgen.denoising_steps)
    rng = np.random.default_rng(1)
    for i, starts in enumerate(([0, 0], [1, 0], [2, 1])):
        noisy = rng.standard_normal((2, 1, 8, 8, 16)).astype(np.float32)
        keys = jax.random.split(jax.random.key(10 + i), 2)
        jx0, jc = jgen.denoise_block(jc, jx, jnp.asarray(noisy), keys,
                                     jnp.asarray(starts, jnp.int32))
        renoise = _jax_slot_renoise(keys, n_steps, (1, 8, 8, 16))
        tx0, tc = tgen.denoise_block(tc, tx, torch.from_numpy(noisy), starts,
                                     renoise=renoise)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_per_slot_generators():
    """A sequence of generators draws each row from its own generator,
    zeros for an idle row; a row's draws do not depend on its slot."""
    cfg = tiny_test_config()
    cfg.runtime.batch_size = 2
    gen = SemiARGenerator(cfg, _params(cfg), dtype=torch.float32, device="cpu")
    x0 = torch.zeros(2, 1, 8, 8, 16)
    a = gen._renoise(x0, [torch.Generator().manual_seed(4), None])
    b = gen._renoise(x0, [None, torch.Generator().manual_seed(4)])
    assert torch.equal(a[0], b[1]) and not a[1].any() and not b[0].any()
    with pytest.raises(ValueError, match="generators"):
        gen._renoise(x0, [None])
