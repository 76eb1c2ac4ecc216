"""The port's W8A8 slice against the JAX package's, at tiny_test_config sizes
(dim 128, ffn 256: every fused branch is taken) in float32 on the CPU.

Both start from the same JAX-quantized parameters (int8 per-channel weights,
f32 scales, carried across with params_from_numpy) and the same numpy
inputs. The port always takes its fused act-quant path; the JAX side runs
its Pallas act-quant kernels in interpret mode: `SemiARGenerator.__init__`
resets the JAX module switch to non-interpret, so each JAX call here sets
`set_fused_act_quant(True, interpret=True)` itself and restores it after;
without that, on the CPU the JAX package would quietly take its XLA chain.
The fused branches of both sides are counted with spies (the JAX side's
at trace time).

Tolerance: 1e-3 relative (||port - jax|| / ||jax||) on a layer's output, a
forward's flow, and the latents and cache of a 2-block generate. The int8
codes are the same on both sides except where an f32 value sits next to a
rounding boundary and the two frameworks' other summation orders and
tanh implementations put it on the other side: a flipped code moves one
product by one quantization step, ~1e-4 of the output's norm at these widths.
Measured (this file's printouts, CPU): a layer's update 4.1e-07, a
forward's flow 1.9e-07, the 2-block latents 1.4e-07 in both context modes,
with 0 of 2048 codes flipped in the first layer's qkv prologue.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.kvcache.cache import init_kv_cache as jax_init_kv_cache
from inferix_tpu.kvcache.cache import valid_mask as jax_valid_mask
from inferix_tpu.models.wan import causal_dit as jdit
from inferix_tpu.ops.rope import build_rope_tables as jax_rope_tables
from inferix_tpu.ops.rope import rope_angles as jax_rope_angles
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu.quant import api as japi
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.kvcache.cache import init_kv_cache, valid_mask
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops.rope import build_rope_tables, rope_angles
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.quant import api as tapi
from inferix_tpu_torch.utils.params import params_from_numpy

RTOL = 1e-3
BLOCKS = 2


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(label, got, want):
    err = _rel(got, want)
    print(f"{label}: rel err {err:.2e} (tol {RTOL:g})")
    assert err <= RTOL


@contextlib.contextmanager
def jax_fused():
    """The JAX package's fused act-quant, in interpret mode, for one call."""
    japi.set_fused_act_quant(True, interpret=True)
    try:
        yield
    finally:
        japi.set_fused_act_quant(False)


def _configs(context_mode="rerun"):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jcfg.quant.fused_act_quant = True
    for c in (jcfg, tcfg):
        c.quant.enabled = True
        c.runtime.context_mode = context_mode
    return jcfg, tcfg


@pytest.fixture(scope="module")
def quantized():
    jcfg, _ = _configs()
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jq = japi.quantize_params(jp, jcfg.quant)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)


@pytest.fixture
def spies(monkeypatch):
    """Counts of the port's fused branches: the LN + modulate prologue, the
    LN (+affine) prologue, and the one-pass act quant (by act)."""
    counts = {"adaln": 0, "ln": 0, None: 0, "gelu": 0, "jax_adaln": 0}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            counts[key(kwargs)] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(tdit, "adaln_quant", lambda kw: "adaln")
    spy(tdit, "ln_quant", lambda kw: "ln")
    spy(tapi, "quantize_rows_int8", lambda kw: kw.get("act"))
    spy(japi, "adaln_quant", lambda kw: "jax_adaln")
    return counts


def test_block_forward(quantized, spies):
    """One fused-qkv W8A8 layer over a cache that already holds one frame:
    its output and the written cache layer."""
    jcfg, tcfg = _configs()
    jq, tq = quantized
    jp, tp = jdit.fuse_qkv_params(jq), tapi.to_kernel_layout(tdit.fuse_qkv_params(tq))
    rng = np.random.default_rng(1)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    fs = js.geo.frame_seq
    x = rng.standard_normal((1, fs, 128)).astype(np.float32)
    e0 = rng.standard_normal((1, 1, 6, 128)).astype(np.float32) * 0.1
    prior = rng.standard_normal((2, 1, fs, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    with jax_fused():
        jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    _check("text K", tx.k, jx.k)
    assert spies[None] == 2 * tcfg.model.num_layers  # K and V of each layer
    jc = jax_init_kv_cache(js.spec)
    jk, jv = jc.k[0].at[:, :fs].set(prior[0]), jc.v[0].at[:, :fs].set(prior[1])
    tc = init_kv_cache(ts.spec, device="cpu")
    tc.k[0][:, :fs] = torch.from_numpy(prior[0])
    tc.v[0][:, :fs] = torch.from_numpy(prior[1])
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"])
    tblock = tdit.layer_params(tp["blocks"], 0)
    jang = jax_rope_angles(jax_rope_tables(32, 64), 1, 4, 4, 1)
    tang = rope_angles(build_rope_tables(32, 64, device="cpu"), 1, 4, 4, 1)
    with jax_fused():
        jy, (jk, jv) = jdit.block_forward(
            jblock, jcfg.model, js.spec, jnp.asarray(x), jnp.asarray(e0), jang,
            (jk, jv), jx.k[0], jx.v[0], None, jnp.int32(fs),
            jax_valid_mask(js.spec, jnp.int32(2 * fs)))
        # the first prologue on both sides: how many int8 codes flip
        mod = jblock["modulation"][None] + jnp.asarray(e0)
        jh, _ = japi.adaln_quant(jnp.asarray(x), mod[:, :, 0], mod[:, :, 1], 1e-6)
    assert spies["jax_adaln"] == 3  # the JAX layer took its fused branches
    before = dict(spies)
    ty, _ = tdit.block_forward(
        tblock, tcfg.model, ts.spec, torch.from_numpy(x), torch.from_numpy(e0),
        tang, (tc.k[0], tc.v[0]), tx.k[0], tx.v[0], fs,
        valid_mask(ts.spec, 2 * fs, device="cpu"))
    # the three fused prologues, and kernel 5 on the o, cross-o and fc2 inputs
    assert (spies["adaln"] - before["adaln"], spies["ln"] - before["ln"]) == (2, 1)
    assert (spies[None] - before[None], spies["gelu"] - before["gelu"]) == (2, 1)
    tmod = tblock["modulation"][None] + torch.from_numpy(e0)
    th, _ = tapi.adaln_quant(torch.from_numpy(x), tmod[:, :, 0], tmod[:, :, 1], 1e-6)
    print(f"qkv prologue: {int((th.numpy() != np.asarray(jh)).sum())} of "
          f"{th.numel()} int8 codes flipped")
    _check("block_forward update", ty - torch.from_numpy(x), np.asarray(jy) - x)
    _check("block_forward cache k", tc.k[0], jk)
    _check("block_forward cache v", tc.v[0], jv)


def test_forward(quantized, spies):
    """One whole W8A8 forward on a fresh cache: flow and cache."""
    jcfg, tcfg = _configs()
    jq, tq = quantized
    jp, tp = jdit.fuse_qkv_params(jq), tapi.to_kernel_layout(tdit.fuse_qkv_params(tq))
    rng = np.random.default_rng(2)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    x = rng.standard_normal((1, 1, 8, 8, 16)).astype(np.float32)
    t = np.full((1, 1), 750.0, np.float32)
    with jax_fused():
        jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
        jflow, jc = jdit.dit_forward_inference(
            jp, js, jax_rope_tables(32, 64), jnp.asarray(x), jnp.asarray(t), jx,
            jax_init_kv_cache(js.spec), jnp.int32(0))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    tflow, tc = tdit.dit_forward_inference(
        tp, ts, build_rope_tables(32, 64, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(t), tx, init_kv_cache(ts.spec, device="cpu"), 0)
    n = tcfg.model.num_layers
    assert spies["jax_adaln"] > 0  # traced with the fused branches
    assert (spies["adaln"], spies["ln"], spies["gelu"]) == (2 * n, n, n)
    assert spies[None] == 2 * n + 2 * n  # text K/V, then o and cross-o
    _check("forward flow", tflow, jflow)
    _check("forward cache k", tc.k, jc.k)


@pytest.fixture(scope="module", params=["rerun", "last_step"])
def generators(request, quantized):
    jcfg, tcfg = _configs(request.param)
    jq, tq = quantized
    jgen = JaxGenerator(jcfg, jq, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, tq, dtype=torch.float32, device="cpu")
    return jgen, tgen


def _jax_renoise(step_rng, n_steps, shape):
    keys = jax.random.split(step_rng, n_steps)
    return [torch.from_numpy(np.array(jax.random.normal(keys[i], shape, jnp.float32)))
            for i in range(n_steps - 1)]


def test_generate(generators, spies):
    """A 2-block clip through generate, fed the JAX-drawn renoise: latents
    and the final cache."""
    jgen, tgen = generators
    m, r = jgen.cfg.model, jgen.cfg.runtime
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((1, m.text_len, m.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, BLOCKS, r.latent_height, r.latent_width,
                                 r.latent_channels)).astype(np.float32)
    key = jax.random.key(4)
    with jax_fused():
        jx = jgen.encode_text_context(jnp.asarray(ctx))
        jlat, jc = jgen.generate(jnp.asarray(noise), jx, key)
    assert spies["jax_adaln"] > 0  # traced with the fused branches
    n = len(jgen.denoising_steps)
    fpb = m.num_frame_per_block
    renoise = []
    for _ in range(BLOCKS):
        key, step_rng = jax.random.split(key)
        renoise.append(_jax_renoise(step_rng, n, (1, fpb) + noise.shape[2:]))
    tx = tgen.encode_text_context(torch.from_numpy(ctx))
    tlat, tc = tgen.generate(torch.from_numpy(noise), tx, renoise=renoise)
    forwards = n + (tgen.context_mode == "rerun")
    assert spies["adaln"] == 2 * m.num_layers * forwards * BLOCKS
    assert tlat.shape == noise.shape
    _check(f"generate {tgen.context_mode} latents", tlat, jlat)
    _check(f"generate {tgen.context_mode} cache k", tc.k, jc.k)
    _check(f"generate {tgen.context_mode} cache v", tc.v, jc.v)


def test_generator_holds_int8_weights_once_in_kernel_layout(generators):
    _, tgen = generators
    qkv = tgen.params["blocks"]["self_attn"]["qkv"]
    assert "w" not in qkv and qkv["w_q"].dtype == torch.int8
    assert qkv["w_q"][0].stride() == (1, qkv["w_q"].shape[1])
    assert qkv["scale"].dtype == torch.float32
