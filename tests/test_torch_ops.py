"""Parity of the PyTorch port's plain ops with the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both. Everything runs
in float32; unless a test says otherwise the tolerance is 1e-5 (absolute and
relative): the two frameworks compute the same float32 arithmetic and differ
only in summation order and in the last ulp of their transcendental functions.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.schedulers import flow_match as jfm
from inferix_tpu.ops import attention as jatt
from inferix_tpu.ops import norms as jnorms
from inferix_tpu.ops import rope as jrope
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.models.schedulers import flow_match as tfm
from inferix_tpu_torch.ops import attention as tatt
from inferix_tpu_torch.ops import norms as tnorms
from inferix_tpu_torch.ops import rope as trope

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL))


def test_rms_and_layer_norm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 2, 5, 64), _rand(rng, 64), _rand(rng, 64)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(tnorms.rms_norm(tx, tw, 1e-6), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(tnorms.layer_norm(tx, eps=1e-6), jnorms.layer_norm(jnp.asarray(x), eps=1e-6))
    _close(tnorms.layer_norm(tx, tw, tb, 1e-6),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6))


@pytest.mark.parametrize("jax_impl", ["mxu", "pairs"])
def test_rope_matches_both_jax_impls(jax_impl):
    """The port's one rope implementation against the JAX default ("mxu",
    the +-1 rotation matmul) and the interleaved-pair formulation."""
    rng = np.random.default_rng(1)
    head_dim, f, h, w, start = 32, 2, 4, 4, 3
    jt = jrope.build_rope_tables(head_dim, 64)
    tt = trope.build_rope_tables(head_dim, 64, device="cpu")
    for a, b in zip(tt, jt):
        _close(a, b, rtol=0, atol=0)
    ja = jrope.rope_angles(jt, f, h, w, start)
    ta = trope.rope_angles(tt, f, h, w, start)
    _close(ta, ja, rtol=0, atol=0)
    x = _rand(rng, 2, f * h * w, 3, head_dim)
    previous = jrope._ROPE_IMPL
    jrope.set_rope_impl(jax_impl)
    try:
        want = jrope.apply_rope(jnp.asarray(x), ja)
    finally:
        jrope.set_rope_impl(previous)
    _close(trope.apply_rope(torch.from_numpy(x), ta), want)


def test_sinusoidal_embedding():
    t = np.array([[0.0, 250.5, 999.0]], np.float32)
    _close(trope.sinusoidal_embedding_1d(32, torch.from_numpy(t)),
           jrope.sinusoidal_embedding_1d(32, jnp.asarray(t)))


@pytest.mark.parametrize("skv,valid", [(96, 50), (2500, 2100)])
def test_attention_reference_and_chunked(skv, valid):
    """The plain attentions with their (out, lse) contract; 2500 keys run
    the chunked online softmax over three 1024-key chunks."""
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 7, 3, 32), _rand(rng, 2, skv, 3, 32), _rand(rng, 2, skv, 3, 32)
    mask = np.arange(skv) < valid
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    for tfn, jfn in ((tatt.attention_reference, jatt.attention_reference),
                     (tatt.attention_chunked, jatt.attention_chunked)):
        out, lse = tfn(tq, tk, tv, tm)
        jout, jlse = jfn(jq, jk, jv, jm)
        _close(out, jout)
        _close(lse, jlse)


@pytest.mark.parametrize("skv,valid,logical", [(16, 16, None), (2500, 1200, None),
                                               (2600, 1200, 2500)])
def test_cache_attention_cpu_path(skv, valid, logical):
    """The dispatcher on CPU tensors takes the plain path, including the
    logical_kv slice-back of a padded allocation."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 9, 2, 32), _rand(rng, 1, skv, 2, 32), _rand(rng, 1, skv, 2, 32)
    mask = np.arange(skv) < valid
    got = tatt.cache_attention(*map(torch.from_numpy, (q, k, v)),
                               kv_mask=torch.from_numpy(mask), logical_kv=logical)
    want = jatt.cache_attention(*map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask),
                                use_pallas=False, logical_kv=logical)
    _close(got, want)


def test_flow_match_schedule():
    js = jfm.FlowMatchSchedule.create(shift=8.0)
    ts = tfm.FlowMatchSchedule.create(shift=8.0, device="cpu")
    _close(ts.sigmas, js.sigmas, rtol=0, atol=0)
    _close(ts.timesteps, js.timesteps, rtol=0, atol=0)
    steps = (1000, 750, 500, 250)
    assert tfm.warp_denoising_steps(ts, steps) == jfm.warp_denoising_steps(js, steps)
    rng = np.random.default_rng(4)
    x0, noise = _rand(rng, 1, 3, 4, 4, 16), _rand(rng, 1, 3, 4, 4, 16)
    t = np.array([[937.5, 512.0, 0.0]], np.float32)
    _close(ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t)),
           js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    _close(ts.flow_to_x0(torch.from_numpy(noise), torch.from_numpy(x0), torch.from_numpy(t)),
           js.flow_to_x0(jnp.asarray(noise), jnp.asarray(x0), jnp.asarray(t)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke, imported in a fresh
    interpreter, leave no `jax` and no `inferix_tpu` module behind."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import inferix_tpu_torch\n"
        "for m in pkgutil.walk_packages(inferix_tpu_torch.__path__, 'inferix_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'inferix_tpu'))\n"
        "assert not bad, bad\n"
        "print('imported', sum(n.startswith('inferix_tpu_torch') for n in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 13


def test_default_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    from inferix_tpu_torch.kvcache.cache import KVCacheSpec, init_kv_cache, valid_mask
    from inferix_tpu_torch.models.schedulers.flow_match import FlowMatchSchedule
    from inferix_tpu_torch.ops.rope import build_rope_tables
    from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
    from inferix_tpu_torch.utils.params import init_params, params_from_numpy

    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg.model, torch.Generator())
    params = init_params(cfg.model, torch.Generator(), device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiARGenerator(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    # the W8A8 entry points: a quantized tree and a quant-enabled generator
    from inferix_tpu_torch.quant.api import quantize_params
    cfg.quant.enabled = True
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiARGenerator(cfg, quantize_params(params, cfg.quant))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w_q": np.zeros((2, 2), np.int8),
                           "scale": np.ones(2, np.float32)})
    # this slice's entry points: the int8 and fp8 KV caches, the window, the VAE
    from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
    from inferix_tpu_torch.utils.params import init_vae_params
    cfg.quant.quantize_kv_cache = True
    cfg.model.local_attn_size, cfg.model.sink_size = 3, 1
    for kv in ("int8", "fp8"):
        cfg.quant.kv_cache_dtype = kv
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SemiARGenerator(cfg, params)
    # the fp8 weight-only entry points: an e4m3 tree, its generator, the bridge
    import ml_dtypes
    cfg.quant.quantize_kv_cache, cfg.quant.dtype = False, "fp8"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiARGenerator(cfg, quantize_params(params, cfg.quant))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w_q": np.zeros((2, 2), np.uint8).view(ml_dtypes.float8_e4m3fn),
                           "scale": np.ones(2, np.float32)})
    vcfg = VAEConfig(dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                     temperal_downsample=(True,))
    spec = KVCacheSpec(num_layers=1, batch=1, max_tokens=8, num_kv_heads=1, head_dim=4)
    qspec = KVCacheSpec(num_layers=1, batch=1, max_tokens=8, num_kv_heads=1, head_dim=4,
                        quantized=True, ring=True, sink_tokens=2)
    for call in (lambda: init_kv_cache(spec), lambda: valid_mask(spec, 4),
                 lambda: init_kv_cache(qspec), lambda: valid_mask(qspec, torch.tensor([4])),
                 lambda: CausalVAE(vcfg), lambda: init_vae_params(vcfg, torch.Generator()),
                 lambda: build_rope_tables(32), lambda: FlowMatchSchedule.create()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the evaluation models: the loaders and the metric classes, before any file is read
    from inferix_tpu_torch.eval.amt import load_amt_s
    from inferix_tpu_torch.eval.raft import load_raft
    from inferix_tpu_torch.eval.vbench_real import AMTMotionSmoothness, RAFTDynamicDegree
    for call in (lambda: load_raft("raft-things.pth"), lambda: load_amt_s("amt-s.pth"),
                 lambda: RAFTDynamicDegree("raft-things.pth"),
                 lambda: AMTMotionSmoothness("amt-s.pth")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
