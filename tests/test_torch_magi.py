"""The port's MAGI-1 DiT (`inferix_tpu_torch.models.magi.dit`) and its GQA
attention wrappers against the JAX package's, float32, on the CPU.

Inputs and weights are drawn with numpy from seeds (the JAX initialiser's
tree, its zero LayerNorm gammas and biases moved off zero, or a
reference-format state dict through `convert_magi_state_dict`) and handed to
both packages; the JAX tree reaches the port through `params_from_numpy`.
Configs: `tiny_magi_config` and a 24B-shaped tiny variant (SwiGLU, the
half-channel VAE, x_rescale_factor 0.1). The port runs attention through
its GQA fold over the flash kernels' plain versions; the JAX package on the
CPU repeats K/V and takes its plain softmax attention.

Tolerances, each with its reason:
- float32 weights over a float32 cache: the same float32 math in other
  summation orders, and the plain flash version's max-free softmax:
  TOL = 1e-4 (measured ~1e-5);
- the int8 window cache: the plain int8-KV version rounds p * v_scale to
  bf16, as the kernel does, where the JAX CPU path dequantizes in float32:
  2^-9 relative a term; velocity and dequantized cache within
  INT8_KV_RTOL = 4e-3 in norm (measured ~8e-4);
- the e4m3 cache and the fp8 distill layout (e4m3 activations): a value
  that the float32 differences above move across an e4m3 rounding
  boundary moves by an e4m3 step (2^-3 relative): E4M3_RTOL = 1e-3 in
  norm (measured ~5e-5);
- W8A8 (the JAX side in its fused act-quant chain, interpreted, so both
  sides fold the same activation arithmetic): one linear is held to 1e-6
  and one layer to W8A8_LAYER_RTOL = 1e-5 in norm (measured 1e-8 and
  1e-7). Through a forward an int8 code next to a rounding tie flips: in
  the first layer's fc2 1 code of 32768 flips on the 5e-7 difference of
  the two sides' exp inside the gelu, which moves its token's row by one
  step (1/127 of the row's absmax), and the next layer's quantizers flip
  ~1% of that token's codes in turn. So a forward's velocity and cache are
  held to W8A8_RTOL = 5e-2 in norm (measured up to 5e-3 over the bf16
  cache, 2e-2 with the int8 window cache as well), the bound the JAX
  package holds its int8 requantized walk to against fp8;
- the GQA wrappers against the JAX wrappers over the Pallas kernels in
  interpret mode: 2e-5 (bf16 K/V as float32 values), and for int8 K/V one
  bf16 ulp of the p * v terms (2^-8), as tests/test_torch_flash_attention.py
  holds the prefix kernels;
- the port against itself (per-chunk against whole window, split fc1
  against concatenated): float32 reduction orders only, 1e-5; the split
  fc1 under W8A8 is bit-equal (the same codes through the same GEMM).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.kvcache.cache import init_kv_cache as jax_init_cache
from inferix_tpu.models.magi import dit as jdit
from inferix_tpu.quant import api as japi
from inferix_tpu.utils.checkpoint import convert_magi_state_dict as jax_convert
from inferix_tpu_torch.kvcache.cache import init_kv_cache
from inferix_tpu_torch.models.magi import dit as tdit
from inferix_tpu_torch.utils.params import params_from_numpy

from test_magi_torch_parity import make_reference_sd

TOL = dict(rtol=1e-4, atol=1e-4)
INT8_KV_RTOL = 4e-3
E4M3_RTOL = 1e-3
W8A8_LAYER_RTOL = 1e-5
W8A8_RTOL = 5e-2
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
LH = LW = 8
MAX_CHUNKS = 4


def _cfgs(name):
    """(JAX config, port config) of the same fields."""
    base = jdit.tiny_magi_config()
    if name == "24b":
        base = dataclasses.replace(base, gated_linear_unit=True, half_channel_vae=True,
                                   in_channels=32, out_channels=32, x_rescale_factor=0.1)
    elif name == "fp8":
        base = dataclasses.replace(base, num_layers=3)
    return base, tdit.MagiModelConfig(**dataclasses.asdict(base))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name in ("bfloat16", "float8_e4m3fn") else x


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturbed_init(cfg, seed):
    """The JAX initialiser's float32 tree as numpy, every LayerNorm leaf and
    bias moved off zero (N(0, 0.1)), so the norms' affine parts and the
    biases take part."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jdit.init_magi_params(jax.random.key(seed), cfg,
                                                          jnp.float32))

    def walk(node, key=""):
        if isinstance(node, dict):
            is_ln = set(node) == {"w", "b"} and node["w"].shape == node["b"].shape
            return {k: (node[k] + rng.standard_normal(node[k].shape).astype(np.float32) * 0.1
                        if (is_ln or k == "b") else walk(node[k], k)) for k in node}
        return node

    return walk(tree)


def _jit(fn, *static_names):
    """fn jitted with the statics static; the JAX fused act-quant switch,
    read at trace time, is a static argument too, so no trace of one
    setting serves the other."""
    @functools.partial(jax.jit, static_argnums=(0, 2), static_argnames=static_names)
    def run(fused, params, statics, *args, **kw):
        return fn(params, statics, *args, **kw)

    return lambda *args, **kw: run(japi.fused_act_quant_on(), *args, **kw)


_jax_forward = _jit(lambda p, s, *a, **k: jdit.magi_forward(p, s, None, *a, **k),
                    "distill_dt_factor")
_jax_window_scan = _jit(lambda p, s, *a, **k: jdit.magi_forward_window_scan(p, s, None, *a, **k))
_jax_uncond = _jit(jdit.magi_forward_uncond)


@pytest.fixture
def fused_jax():
    """The JAX int8 paths in their fused act-quant chain, interpreted (the
    arithmetic the port's act-quant kernel and plain version repeat)."""
    japi.set_fused_act_quant(True, interpret=True)
    yield
    japi.set_fused_act_quant(False)


def _trees(kind):
    """(JAX config, port config, JAX tree, port tree) of a weights kind."""
    jcfg, tcfg = _cfgs("fp8" if kind in ("fp8", "fp8_int8") else
                       "24b" if kind.startswith("24b") else "tiny")
    if kind in ("fp8", "fp8_int8"):
        jp = jax_convert(make_reference_sd(jcfg, fp8_layers=(1,)), jcfg, dtype=jnp.float32)
        if kind == "fp8_int8":
            jp = japi.magi_distill_quant_to_int8(jp)
        npt = jax.tree.map(np.asarray, jp)
    else:
        npt = _perturbed_init(jcfg, 3)
        if kind.endswith("int8"):
            npt = jax.tree.map(np.asarray, japi.magi_quantize_params_int8(
                jax.tree.map(jnp.asarray, npt)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, npt),
            params_from_numpy(npt, "cpu", torch.float32))


def _statics(jcfg, tcfg, batch, cache):
    kw_j = dict(quantize_kv=cache == "int8",
                kv_dtype=jnp.float8_e4m3fn if cache == "e4m3" else None)
    kw_t = dict(quantize_kv=cache == "int8",
                kv_dtype=torch.float8_e4m3fn if cache == "e4m3" else None)
    return (jdit.make_magi_statics(jcfg, batch, LH, LW, MAX_CHUNKS, jnp.float32, **kw_j),
            tdit.make_magi_statics(tcfg, batch, LH, LW, MAX_CHUNKS, torch.float32, **kw_t))


def _inputs(cfg, batch, n_chunks, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n_chunks * cfg.chunk_width, LH, LW,
                             cfg.latent_channels)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (batch, n_chunks)).astype(np.float32)
    cap = rng.standard_normal((batch, n_chunks, cfg.caption_max_length,
                               cfg.caption_channels)).astype(np.float32)
    cmask = np.zeros((batch, n_chunks, cfg.caption_max_length), np.float32)
    for i in range(batch):
        for c in range(n_chunks):   # prefix masks of 1..cap_len tokens
            cmask[i, c, :rng.integers(1, cfg.caption_max_length + 1)] = 1.0
    return x, t, cap, cmask


def _cache_values(cache, quantized):
    """A cache's K and V as float32 values (int8 dequantized)."""
    if quantized:
        return [_np(c).astype(np.float32) * _np(s)[..., None]
                for c, s in ((cache[0], cache[2]), (cache[1], cache[3]))]
    return [_np(cache[0]), _np(cache[1])]


WINDOWS = ((0, [[0, 1], [0, 2]]), (2, [[0, 3], [1, 4]]))


def _check(name, got, want, kind, cache, scale=1.0, rtol=None):
    """got against want at the tolerance of the weights and cache kind (or
    rtol in norm); scale: 1 / x_rescale_factor for a velocity, which the
    forward divides by it (errors and values grow alike)."""
    if rtol is not None:
        pass
    elif kind.endswith("int8"):
        rtol = W8A8_RTOL
    elif cache == "int8":
        rtol = INT8_KV_RTOL
    elif cache == "e4m3" or kind.startswith("fp8"):
        rtol = E4M3_RTOL
    else:
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale)
        return
    err = _rel(got, want)
    print(f"{name}: rel err {err:.3g}")
    assert np.isfinite(_np(got)).all() and err <= rtol, (name, err)


@pytest.mark.parametrize("kind,cache", [
    ("init", "model"), ("init", "int8"), ("init", "e4m3"), ("24b", "model"),
    ("fp8", "model"), ("init_int8", "model"), ("init_int8", "int8"),
    ("24b_int8", "model"), ("24b_int8", "e4m3"), ("fp8_int8", "e4m3"),
])
def test_magi_forward_matches_jax(kind, cache, fused_jax):
    """Two windows over one cache (the second attends the first's K/V): the
    velocity and every cache field after each, B=2 with caption_dropout
    [False, True], distill_dt_factor on the fp8 layouts."""
    jcfg, tcfg, jp, tp = _trees(kind)
    js, ts = _statics(jcfg, tcfg, 2, cache)
    jc, tc = jax_init_cache(js.spec), init_kv_cache(ts.spec, "cpu")
    ddt = 2.0 if kind.startswith("fp8") else None
    drop = np.asarray([False, True])
    for wi, (sp, kvr) in enumerate(WINDOWS):
        x, t, cap, cmask = _inputs(jcfg, 2, 2, 10 + wi)
        jv, jc = _jax_forward(jp, js, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(cap), jnp.asarray(cmask), jc,
                                   jnp.int32(sp), jnp.asarray(kvr, jnp.int32),
                                   distill_dt_factor=ddt, caption_dropout=jnp.asarray(drop))
        tv, tc = tdit.magi_forward(tp, ts, None, torch.from_numpy(x), t,
                                   torch.from_numpy(cap), cmask, tc, sp, kvr,
                                   distill_dt_factor=ddt,
                                   caption_dropout=torch.from_numpy(drop))
        assert tv.shape == jv.shape and tv.dtype == torch.float32
        _check(f"{kind}/{cache} window {wi} velocity", tv, jv, kind, cache,
               1 / jcfg.x_rescale_factor)
        quant = cache == "int8"
        for f, (a, b) in zip("kv", zip(_cache_values(tc, quant), _cache_values(jc, quant))):
            _check(f"{kind}/{cache} window {wi} cache {f}", a, b, kind, cache)


@pytest.mark.parametrize("kind,cache", [("init", "model"), ("24b_int8", "int8")])
def test_window_scan_and_uncond_match_jax(kind, cache, fused_jax):
    """`magi_forward_window_scan` (a loop here, a lax.scan there) at B=2,
    then `sync_cache_rows` over its span, and `magi_forward_uncond` over the
    window's chunks as rows with the null caption."""
    jcfg, tcfg, jp, tp = _trees(kind)
    js, ts = _statics(jcfg, tcfg, 2, cache)
    jc, tc = jax_init_cache(js.spec), init_kv_cache(ts.spec, "cpu")
    x, t, cap, cmask = _inputs(jcfg, 2, 3, 21)
    kvr = [[0, 1], [0, 2], [1, 3]]
    drop = np.asarray([False, True])
    jv, jc = _jax_window_scan(
        jp, js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cap), jnp.asarray(cmask),
        jc, jnp.int32(0), jnp.asarray(kvr, jnp.int32), caption_dropout=jnp.asarray(drop))
    tv, tc = tdit.magi_forward_window_scan(
        tp, ts, None, torch.from_numpy(x), t, torch.from_numpy(cap), cmask, tc, 0, kvr,
        caption_dropout=torch.from_numpy(drop))
    _check(f"{kind} scan velocity", tv, jv, kind, cache, 1 / jcfg.x_rescale_factor)
    ct = ts.geo.chunk_tokens
    jc = jdit.sync_cache_rows(js.spec, jc, jnp.int32(0), 3 * ct)
    tc2 = tdit.sync_cache_rows(ts.spec, tc, 0, 3 * ct)
    assert tc2 is tc
    quant = cache == "int8"
    for a, b in zip(_cache_values(tc, quant), _cache_values(jc, quant)):
        _check(f"{kind} synced cache", a, b, kind, cache)
        assert np.array_equal(a[:, 0], a[:, 1])
    cw = jcfg.chunk_width
    xu = x[1].reshape(3, cw, LH, LW, -1)
    capu, masku = cap[1][:, None], cmask[1][:, None]
    tu = t[1][:, None]
    ju = _jax_uncond(jp, js, jnp.asarray(xu), jnp.asarray(tu), jnp.asarray(capu),
                                  jnp.asarray(masku))
    tu_ = tdit.magi_forward_uncond(tp, ts, torch.from_numpy(xu), tu, torch.from_numpy(capu),
                                   masku)
    assert tu_.shape == ju.shape
    _check(f"{kind} uncond", tu_, ju, kind, "model", 1 / jcfg.x_rescale_factor)


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_per_chunk_equals_whole_window(cache):
    """The port's per-chunk dispatch against its whole-window forward over
    the same cache state: velocity and cache (the int8 cache's K/V are
    written from float32 values equal to 1e-5, so codes may flip: held to
    INT8_KV_RTOL in norm)."""
    _, tcfg, _, tp = _trees("init")
    ts = tdit.make_magi_statics(tcfg, 1, LH, LW, MAX_CHUNKS, torch.float32,
                                quantize_kv=cache == "int8")
    caches = [init_kv_cache(ts.spec, "cpu") for _ in range(2)]
    for sp, kvr in WINDOWS:
        x, t, cap, cmask = _inputs(tcfg, 1, 2, sp)
        args = (torch.from_numpy(x), t, torch.from_numpy(cap), cmask)
        vw, _ = tdit.magi_forward(tp, ts, None, *args, caches[0], sp, kvr)
        vc, _ = tdit.magi_forward_window_scan(tp, ts, None, *args, caches[1], sp, kvr)
        if cache == "model":
            torch.testing.assert_close(vc, vw, **SELF_TOL)
            for a, b in zip(caches[1], caches[0]):
                torch.testing.assert_close(a, b, **SELF_TOL)
        else:
            assert _rel(vc, vw) <= INT8_KV_RTOL
            for a, b in zip(_cache_values(caches[1], True), _cache_values(caches[0], True)):
                assert _rel(a, b) <= INT8_KV_RTOL
