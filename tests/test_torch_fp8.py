"""The port's fp8 (e4m3) weight-only slice against the JAX package's, on the
CPU, at tiny_test_config sizes (dim 128, ffn 256).

Inputs are drawn with numpy from a seed and handed to both; the JAX side's
Pallas fp8 GEMM runs in interpret mode, the port's wrapper takes its plain
version on CPU tensors. Tolerances, each with its reason:
- the quantizer repeats the JAX arithmetic exactly: codes bit-equal through
  uint8 views, scales with rtol 0;
- the GEMM's plain version sums exact products (e4m3 times bf16 or f32) in
  float32 in another order than XLA's dot: 1e-6 relative and absolute in
  float32;
- a layer, a forward and a 2-block generate in float32: the JAX XLA chain
  (`quant/api.py:130-133`) and the port both use x unrounded, sum in float32
  and apply the scale before one rounding to float32, so only summation
  orders differ: 1e-5 relative (||port - jax|| / ||jax||). Measured (this
  file's printouts, CPU): ~1e-7;
- bf16: the JAX XLA chain rounds jnp.dot to bf16 before the scale and again
  after it; the port (the kernel's contract) rounds once, after the scale.
  The two differ by up to a bf16 ulp of each linear's output: a linear and
  an FFN held to 1e-2 relative (measured 2.8e-3 and 5.3e-3). A whole bf16
  layer differs from the JAX one by 2.5e-2 already with float weights (the
  two frameworks round the norms, rope and attention at other points); with
  e4m3 weights it is held to 5e-2 (measured 3.2e-2). Both printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import QuantConfig as JaxQuantConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.kvcache.cache import init_kv_cache as jax_init_kv_cache
from inferix_tpu.kvcache.cache import valid_mask as jax_valid_mask
from inferix_tpu.models.wan import causal_dit as jdit
from inferix_tpu.ops.rope import build_rope_tables as jax_rope_tables
from inferix_tpu.ops.rope import rope_angles as jax_rope_angles
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu.quant import api as japi
from inferix_tpu.quant import kernels as jk
from inferix_tpu_torch.core.config import QuantConfig, tiny_test_config
from inferix_tpu_torch.kvcache.cache import init_kv_cache, valid_mask
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops.rope import build_rope_tables, rope_angles
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.quant import api as tapi
from inferix_tpu_torch.quant import kernels as tk
from inferix_tpu_torch.utils.params import params_from_numpy

F32_RTOL = 1e-5
BF16_LINEAR_RTOL = 1e-2
BF16_LAYER_RTOL = 5e-2
BLOCKS = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _bits(x) -> np.ndarray:
    """e4m3 codes as uint8, from a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(label, got, want, tol=F32_RTOL):
    err = _rel(got, want)
    print(f"{label}: rel err {err:.2e} (tol {tol:g})")
    assert err <= tol


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_weight_fp8(per_channel, stacked):
    """Codes bit-equal to the JAX quantizer's (uint8 views), scales equal;
    an all-zero channel, large and tiny values (e4m3 subnormals) included."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 96, 80) if stacked else (96, 80)).astype(np.float32)
    w[..., 5] = 0.0
    w[..., 7] *= 1e-4
    w[..., 3, :] *= 40.0
    qfn = lambda wi: jk.quantize_weight_fp8(wi, per_channel)
    jq, js = jax.vmap(qfn)(jnp.asarray(w)) if stacked else qfn(jnp.asarray(w))
    tq, ts = tk.quantize_weight_fp8(torch.from_numpy(w), per_channel)
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n,per_channel", [
    (100, 256, 384, True),    # ragged M against the Pallas blocks
    (1, 128, 256, True),
    (64, 512, 128, False),    # one scale for all
    (33, 96, 136, True),      # K, N off the 128 grid
])
def test_fp8_matmul_reference_matches_jax(m, k, n, per_channel):
    """The plain version against the Pallas kernel (interpret, bf16 x) and
    the XLA chain (float32 x) on bf16-valued x, so that both see the same
    values; f32 out within 1e-6. The kernel's K-contiguous weight layout
    gives the same numbers (up to the CPU matmul's summation order), and
    bf16 out is the f32 result rounded once."""
    rng = np.random.default_rng(2)
    x = np.array(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
                 .astype(jnp.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jq, js = jk.quantize_weight_fp8(jnp.asarray(w), per_channel)
    want_pallas = jk.fp8_matmul(jnp.asarray(x, jnp.bfloat16), jq, js,
                                out_dtype=jnp.float32, bm=16, bn=128, bk=128,
                                interpret=True)
    want_xla = jk.fp8_matmul_xla(jnp.asarray(x), jq, js, out_dtype=jnp.float32)
    tq = torch.from_numpy(_bits(jq).copy()).view(torch.float8_e4m3fn)
    ts = torch.from_numpy(np.array(js))
    got = tk.fp8_matmul_reference(torch.from_numpy(x), tq, ts, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), rtol=1e-6, atol=1e-6)
    got_t = tk.fp8_matmul(torch.from_numpy(x).bfloat16(), tq.t().contiguous().t(), ts,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got_t.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
    got_bf = tk.fp8_matmul(torch.from_numpy(x).bfloat16(), tq, ts)
    assert got_bf.dtype == torch.bfloat16 and torch.equal(got_bf, got.bfloat16())


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
def test_params_bridge_carries_e4m3(granularity):
    """A JAX fp8-quantized tree through params_from_numpy equals the port's
    own quantization of the same float weights: every key, dtype, shape,
    code (bit for bit) and scale, before and after fuse_qkv_params; the
    scales stay float32 in a bf16 model, the codes are never cast."""
    cfg = jax_tiny_config()
    jp = jdit.init_params(jax.random.key(0), cfg.model, dtype=jnp.float32)
    jqc = JaxQuantConfig(enabled=True, dtype="fp8", granularity=granularity)
    tqc = QuantConfig(enabled=True, dtype="fp8", granularity=granularity)
    jq = japi.quantize_params(jp, jqc)
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.bfloat16)
    own = tapi.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32), tqc)
    for a, b in ((carried, own), (tdit.fuse_qkv_params(carried), tdit.fuse_qkv_params(own))):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        n_q = 0
        for key in fa:
            if key.endswith("w_q"):
                n_q += 1
                assert fa[key].dtype == fb[key].dtype == torch.float8_e4m3fn, key
                np.testing.assert_array_equal(_bits(fa[key]), _bits(fb[key]), err_msg=key)
            elif key.endswith("scale"):
                assert fa[key].dtype == torch.float32, key
                np.testing.assert_array_equal(fa[key].numpy(), fb[key].numpy(), err_msg=key)
        assert n_q == (10 if "blocks/self_attn/q/w_q" in fa else 8)
    want = np.asarray(jdit.fuse_qkv_params(jq)["blocks"]["self_attn"]["qkv"]["w_q"])
    got = tdit.fuse_qkv_params(carried)["blocks"]["self_attn"]["qkv"]["w_q"]
    np.testing.assert_array_equal(_bits(got), want.view(np.uint8))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_linear_and_ffn_match_jax(dtype):
    """quantized_linear and quantized_ffn with e4m3 weights against the JAX
    XLA chain: within F32_RTOL in float32; in bf16 the rounding points differ
    (see the module docstring) and the difference is printed."""
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ws = [rng.standard_normal(s).astype(np.float32) * 0.05
          for s in ((128, 256), (256, 128))]
    bs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (256, 128)]
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    jqc = JaxQuantConfig(enabled=True, dtype="fp8")
    qc = QuantConfig(enabled=True, dtype="fp8")
    jps = [japi._quantize_leaf_linear({"w": jnp.asarray(w, jdt), "b": jnp.asarray(b, jdt)},
                                      jqc) for w, b in zip(ws, bs)]
    tps = [tapi._quantize_leaf_linear(
        {"w": torch.from_numpy(np.array(jnp.asarray(w, jdt).astype(jnp.float32))).to(dtype),
         "b": torch.from_numpy(np.array(jnp.asarray(b, jdt).astype(jnp.float32))).to(dtype)},
        qc) for w, b in zip(ws, bs)]
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(_bits(tp["w_q"]), _bits(jp["w_q"]))
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    lin = tapi.quantized_linear(tps[0], tx)
    ffn = tapi.quantized_ffn(tps[0], tps[1], tx)
    assert lin.dtype == dtype and lin.shape == (2, 9, 256) and ffn.shape == (2, 9, 128)
    tol = F32_RTOL if dtype == torch.float32 else BF16_LINEAR_RTOL
    want = japi.quantized_linear(jps[0], jx)
    diff = np.abs(_np(lin) - _np(want))
    print(f"quantized_linear fp8 {dtype}: max |diff| {diff.max():.4e} (max |out| "
          f"{np.abs(_np(want)).max():.4e}), share of outputs that differ "
          f"{(diff > 0).mean():.3f}")
    _check(f"quantized_linear fp8 {dtype}", lin, want, tol)
    _check(f"quantized_ffn fp8 {dtype}", ffn, japi.quantized_ffn(jps[0], jps[1], jx), tol)


def _configs(context_mode="rerun"):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jcfg.quant.dtype = "fp8"
    tcfg.quant = QuantConfig(enabled=True, dtype="fp8")
    jcfg.quant.enabled = True
    for c in (jcfg, tcfg):
        c.runtime.context_mode = context_mode
    return jcfg, tcfg


def _trees(dtype):
    jcfg, _ = _configs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jdt)
    jq = japi.quantize_params(jp, jcfg.quant)
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", dtype)


@pytest.fixture(scope="module")
def quantized():
    return _trees(torch.float32)


def _layer(jq, tq, dtype):
    """One fused-qkv fp8 layer over a cache that already holds one frame,
    on both sides: (JAX update, port update, JAX cache k, port cache k)."""
    jcfg, tcfg = _configs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp, tp = jdit.fuse_qkv_params(jq), tapi.to_kernel_layout(tdit.fuse_qkv_params(tq))
    rng = np.random.default_rng(1)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jdt)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, dtype)
    fs = js.geo.frame_seq
    to_j = lambda a: jnp.asarray(a, jdt)
    to_t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jdt).astype(jnp.float32))).to(dtype)
    x = rng.standard_normal((1, fs, 128)).astype(np.float32)
    e0 = rng.standard_normal((1, 1, 6, 128)).astype(np.float32) * 0.1
    prior = rng.standard_normal((2, 1, fs, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, to_j(ctx))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, to_t(ctx))
    jc = jax_init_kv_cache(js.spec)
    jkc, jvc = jc.k[0].at[:, :fs].set(to_j(prior[0])), jc.v[0].at[:, :fs].set(to_j(prior[1]))
    tc = init_kv_cache(ts.spec, device="cpu")
    tc.k[0][:, :fs] = to_t(prior[0])
    tc.v[0][:, :fs] = to_t(prior[1])
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"])
    tblock = tdit.layer_params(tp["blocks"], 0)
    jang = jax_rope_angles(jax_rope_tables(32, 64), 1, 4, 4, 1)
    tang = rope_angles(build_rope_tables(32, 64, device="cpu"), 1, 4, 4, 1)
    jy, (jkc, _) = jdit.block_forward(
        jblock, jcfg.model, js.spec, to_j(x), jnp.asarray(e0), jang, (jkc, jvc),
        jx.k[0], jx.v[0], None, jnp.int32(fs), jax_valid_mask(js.spec, jnp.int32(2 * fs)))
    ty, _ = tdit.block_forward(
        tblock, tcfg.model, ts.spec, to_t(x), torch.from_numpy(e0), tang,
        (tc.k[0], tc.v[0]), tx.k[0], tx.v[0], fs, valid_mask(ts.spec, 2 * fs, device="cpu"))
    xj = np.asarray(to_j(x).astype(jnp.float32))
    return (np.asarray(jy.astype(jnp.float32)) - xj, _np(ty) - xj, jkc, tc.k[0], jx, tx)


def test_block_forward(quantized, monkeypatch):
    """One fp8 layer, float32: its update, the written cache layer and the
    text K/V, with every block linear through the fp8 GEMM (the text K/V's
    two per layer included) and no int8 prologue."""
    calls = []
    real = tapi.fp8_matmul
    monkeypatch.setattr(tapi, "fp8_matmul", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tdit, "adaln_quant", None)  # an int8 prologue would fail
    monkeypatch.setattr(tdit, "ln_quant", None)
    jq, tq = quantized
    jupd, tupd, jkc, tkc, jx, tx = _layer(jq, tq, torch.float32)
    n = tiny_test_config().model.num_layers
    assert len(calls) == 2 * n + 6  # text K/V of every layer, then 6 in the layer
    _check("text K", tx.k, jx.k)
    _check("block_forward update", tupd, jupd)
    _check("block_forward cache k", tkc, jkc)


def test_block_forward_bf16_rounding_points():
    """The bf16 case: JAX rounds each dot to bf16 before the scale, the port
    rounds once after it. The layer's update stays within BF16_LAYER_RTOL;
    the same layer with the float weights is printed beside it."""
    jcfg, _ = _configs()
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    jupd, tupd, *_ = _layer(jp, tp, torch.bfloat16)
    print(f"block_forward bf16, float weights: rel err {_rel(tupd, jupd):.2e}")
    jq, tq = _trees(torch.bfloat16)
    jupd, tupd, *_ = _layer(jq, tq, torch.bfloat16)
    _check("block_forward bf16, e4m3 weights", tupd, jupd, BF16_LAYER_RTOL)


def test_forward(quantized):
    """One whole fp8 forward on a fresh cache: flow and cache."""
    jcfg, tcfg = _configs()
    jq, tq = quantized
    jp, tp = jdit.fuse_qkv_params(jq), tapi.to_kernel_layout(tdit.fuse_qkv_params(tq))
    rng = np.random.default_rng(2)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    x = rng.standard_normal((1, 1, 8, 8, 16)).astype(np.float32)
    t = np.full((1, 1), 750.0, np.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
    jflow, jc = jdit.dit_forward_inference(
        jp, js, jax_rope_tables(32, 64), jnp.asarray(x), jnp.asarray(t), jx,
        jax_init_kv_cache(js.spec), jnp.int32(0))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    tflow, tc = tdit.dit_forward_inference(
        tp, ts, build_rope_tables(32, 64, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(t), tx, init_kv_cache(ts.spec, device="cpu"), 0)
    _check("forward flow", tflow, jflow)
    _check("forward cache k", tc.k, jc.k)


@pytest.mark.parametrize("context_mode", ["rerun", "last_step"])
def test_generate(quantized, context_mode):
    """A 2-block fp8 clip through generate, fed the JAX-drawn renoise:
    latents and the final cache; the generator holds each e4m3 weight once,
    K-contiguous."""
    jcfg, tcfg = _configs(context_mode)
    jq, tq = quantized
    jgen = JaxGenerator(jcfg, jq, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, tq, dtype=torch.float32, device="cpu")
    qkv = tgen.params["blocks"]["self_attn"]["qkv"]
    assert qkv["w_q"].dtype == torch.float8_e4m3fn and qkv["scale"].dtype == torch.float32
    assert qkv["w_q"][0].stride() == (1, qkv["w_q"].shape[1])
    m, r = jcfg.model, jcfg.runtime
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((1, m.text_len, m.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, BLOCKS, r.latent_height, r.latent_width,
                                 r.latent_channels)).astype(np.float32)
    key = jax.random.key(4)
    jx = jgen.encode_text_context(jnp.asarray(ctx))
    jlat, jc = jgen.generate(jnp.asarray(noise), jx, key)
    n = len(jgen.denoising_steps)
    fpb = m.num_frame_per_block
    renoise = []
    for _ in range(BLOCKS):
        key, step_rng = jax.random.split(key)
        keys = jax.random.split(step_rng, n)
        renoise.append([torch.from_numpy(np.array(jax.random.normal(
            keys[i], (1, fpb) + noise.shape[2:], jnp.float32))) for i in range(n - 1)])
    tx = tgen.encode_text_context(torch.from_numpy(ctx))
    tlat, tc = tgen.generate(torch.from_numpy(noise), tx, renoise=renoise)
    assert tlat.shape == noise.shape
    _check(f"generate {context_mode} latents", tlat, jlat)
    _check(f"generate {context_mode} cache k", tc.k, jc.k)
    _check(f"generate {context_mode} cache v", tc.v, jc.v)


def test_kernel_layout_and_memory_of_e4m3_leaves():
    """to_kernel_layout makes one K-contiguous copy of each e4m3 weight
    with the same bits; memory_bytes counts one byte a code."""
    rng = np.random.default_rng(7)
    w_q = torch.from_numpy(rng.standard_normal((2, 64, 48)).astype(np.float32)).to(
        torch.float8_e4m3fn)
    tree = {"lin": {"w_q": w_q, "scale": torch.ones(2, 48), "b": torch.zeros(2, 48)}}
    got = tapi.to_kernel_layout(tree)["lin"]["w_q"]
    assert got.dtype == torch.float8_e4m3fn and got.shape == w_q.shape
    assert got[1].stride() == (1, 64)
    assert torch.equal(got.view(torch.uint8), w_q.view(torch.uint8))
    assert tapi.memory_bytes(tree) == 2 * 64 * 48 + 2 * 2 * 48 * 4


@pytest.mark.parametrize("kernel,m,n,plan", [
    ("int8", 4680, 4608, (224, 777, 132)), ("int8", 4680, 1536, (224, 259, 132)),
    ("int8", 4680, 8960, (256, 1295, 132)), ("int8", 512, 1536, (128, 48, 48)),
    ("int8", 70, 1536, (128, 12, 12)), ("int8", 1, 1536, (128, 12, 12)),
    ("int8", 100, 8, (128, 1, 1)), ("int8", 9360, 1536, (224, 518, 132)),
    ("int8", 9360, 8960, (256, 2590, 132)), ("int8", 133 * 128, 128, (128, 133, 132)),
    ("fp8", 4680, 4608, (224, 756, 132)), ("fp8", 4680, 1536, (224, 252, 132)),
    ("fp8", 4680, 8960, (224, 1470, 132)), ("fp8", 512, 1536, (128, 48, 48)),
    ("fp8", 70, 1536, (128, 12, 12)), ("fp8", 1, 1536, (128, 12, 12)),
    ("fp8", 100, 8, (128, 1, 1)), ("fp8", 9360, 1536, (224, 504, 132)),
    ("fp8", 9360, 8960, (256, 2590, 132)), ("fp8", 128, 133 * 128, (128, 133, 132))])
def test_gemm_plan(kernel, m, n, plan):
    """The tile plan of both quantized GEMMs (one persistent kernel frame)
    at the paths' and the gates' shapes: (tile width, tiles, CTAs). Tiles
    are 128 tokens (int8) or 128 channels (fp8, the transposed product) by
    the width; the width costs the least over rounds of 132 SMs, a tile
    costing its width plus 48 columns (224 where 256 leaves a second round
    of 90 tiles), the wider on a tie; one CTA an SM, or one a tile when
    there are fewer tiles."""
    assert tk.gemm_plan(m, n, kernel) == plan
    bn, tiles, grid = plan
    rows, cols = (n, m) if kernel == "fp8" else (m, n)
    assert tiles == -(-rows // tk.GEMM_TILE_M) * -(-cols // bn)
    assert grid == min(tiles, tk.H100_SMS)


def test_gemm_plan_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="'int8' or 'fp8'"):
        tk.gemm_plan(16, 16, "int4")


@pytest.mark.parametrize("loader,entry", [("_kernel", "inferix_int8_matmul"),
                                          ("_fp8_kernel", "inferix_fp8_matmul")])
def test_both_gemms_load_one_library(monkeypatch, loader, entry):
    """The int8 and the fp8 wrappers take their entry points from the one
    library built from csrc/gemm_sm90.cu."""
    asked = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {"argtypes": None, "restype": None})()
            fn.name = name
            return fn
    monkeypatch.setattr(tk._build, "load_library", lambda name: asked.append(name) or Lib())
    fn = getattr(tk, loader)()
    assert asked == [tk.GEMM_LIBRARY] and tk.GEMM_LIBRARY == "gemm_sm90"
    assert fn.name == entry and fn.argtypes is not None
