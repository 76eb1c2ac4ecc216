"""The cache's head-major and padded layouts (`KVCacheSpec.head_major`,
`alloc_tokens`; the switches `runtime.kv_head_major` / `kv_alloc_pad`)
against the JAX package, on the CPU.

- writes: each field bit-equal to the JAX `write_block` after every write,
  for the global window, a ring that wraps more than once with and without
  sink slots, float32, int8 (codes and scales) and e4m3 caches, head-major,
  padded and both;
- the padded allocation's rounding, the too-small refusal, the mask over
  the padded slots, `cache_attention` over a head-major layer;
- a 2-block `generate` with each switch against the JAX generator with the
  same switch, fed the JAX renoise (float32, 1e-4 as
  tests/test_torch_semi_ar.py), and against the port's own switches-off run
  (bit-equal: the same values through views);
- a small MAGI walk with both layouts against the JAX walk (WALK_RTOL, as
  tests/test_torch_magi_pipeline.py), and a JAX head-major state, saved by
  the JAX package mid-walk, resumed by the port;
- the config keys taken by `EngineConfig.from_dict`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import EngineConfig as JaxEngineConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.kvcache import cache as jcache
from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params
from inferix_tpu.models.wan.causal_dit import make_kv_spec as jax_make_kv_spec
from inferix_tpu.ops import attention as jatt
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu.utils.state_checkpoint import save_generation_state as jax_save_state
from inferix_tpu_torch.core.config import EngineConfig, tiny_test_config
from inferix_tpu_torch.kvcache import cache as tcache
from inferix_tpu_torch.models.wan.causal_dit import make_kv_spec
from inferix_tpu_torch.ops import attention as tatt
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import params_from_numpy
from inferix_tpu_torch.utils.state_checkpoint import load_generation_state

from test_torch_magi_pipeline import (  # noqa: F401 - trees and injected are fixtures
    CHUNKS, WALK_RTOL, _jax_pipe, _port_pipe, _rel, _runtime, _walk, injected, trees)
from test_torch_semi_ar import _jax_renoise

L, B, S, H, D = 2, 2, 64, 3, 8
TOL = dict(rtol=1e-4, atol=1e-4)
LAYOUTS = {"head_major": dict(head_major=True),
           "padded": dict(alloc_tokens=96),
           "head_major_padded": dict(head_major=True, alloc_tokens=96)}
KINDS = {"float32": ((jnp.float32, torch.float32), False),
         "int8": ((jnp.float32, torch.float32), True),
         "e4m3": ((jnp.float8_e4m3fn, torch.float8_e4m3fn), False)}
WINDOWS = {"global": dict(), "ring": dict(ring=True), "ring_sink": dict(ring=True, sink_tokens=16)}


def _specs(layout, kind, window):
    (jd, td), quantized = KINDS[kind]
    kw = dict(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H, head_dim=D,
              quantized=quantized, **LAYOUTS[layout], **WINDOWS[window])
    granule = dict(granule=16) if kw.get("ring") else {}
    return jcache.KVCacheSpec(dtype=jd, **granule, **kw), tcache.KVCacheSpec(dtype=td, **kw)


def _bits(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jbits(j):
    a = np.asarray(j)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_writes_match_jax(layout, kind, window):
    """Successive 24-token blocks (3 * S tokens: the ring wraps more than
    once, a block straddles the wrap) into layer 1, every field bit-equal
    to the JAX cache after each write; the slots past max_tokens never
    written."""
    jspec, tspec = _specs(layout, kind, window)
    jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
    for t, j in zip(tc, jc):
        assert (t is None) == (j is None)
        if t is not None:
            assert tuple(t.shape) == tuple(j.shape) and t.dtype == getattr(torch, str(j.dtype))
    jl = [f[1] for f in jc if f is not None]
    tl = [f[1] for f in tc if f is not None]
    rng = np.random.default_rng(20)
    n, end = 24, (3 * S if tspec.ring else S)
    for s0 in range(0, end - n + 1, n):
        kn, vn = (rng.standard_normal((B, n, H, D)) * 3).astype(np.float32), \
            (rng.standard_normal((B, n, H, D)) * 3).astype(np.float32)
        jl = list(jcache.write_block(jspec, jl[0], jl[1], jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.int32(s0), *jl[2:]))
        out = tcache.write_block(tspec, tl[0], tl[1], torch.from_numpy(kn),
                                 torch.from_numpy(vn), s0, *tl[2:])
        assert all(o is t for o, t in zip(out, tl))  # in place
        for t, j in zip(tl, jl):
            np.testing.assert_array_equal(_bits(t), _jbits(j))
    for t in tl:
        pad = tcache.token_major(t, tspec.head_major)[:, S:]
        assert not pad.float().any()
    for e in (0, 40, S, 2 * S + 8):
        np.testing.assert_array_equal(tcache.valid_mask(tspec, e, device="cpu").numpy(),
                                      np.asarray(jcache.valid_mask(jspec, jnp.int32(e))))


def test_per_row_starts_head_major():
    """[B] starts into a head-major int8 ring, bit-equal to JAX."""
    jspec, tspec = _specs("head_major", "int8", "ring_sink")
    jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
    jl, tl = [f[0] for f in jc], [f[0] for f in tc]
    rng = np.random.default_rng(21)
    kn, vn = (rng.standard_normal((B, 32, H, D)).astype(np.float32) for _ in range(2))
    starts = [32, 112]
    jl = jcache.write_block(jspec, jl[0], jl[1], jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(starts, jnp.int32), *jl[2:])
    tcache.write_block(tspec, tl[0], tl[1], torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.tensor(starts), *tl[2:])
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_alloc_tokens_rounding_and_refusal():
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    for mult in (0, 16, 2048, 100):
        js = jax_make_kv_spec(jcfg.model, 1, 8, 8, jnp.float32, alloc_multiple=mult)
        ts = make_kv_spec(tcfg.model, 1, 8, 8, torch.float32, alloc_multiple=mult)
        assert (ts.max_tokens, ts.alloc_tokens, ts.slots) == \
            (js.max_tokens, js.alloc_tokens, js.slots)
    assert ts.slots == 100 and make_kv_spec(tcfg.model, 1, 8, 8, alloc_multiple=2048).slots == 2048
    for mod in (jcache, tcache):
        with pytest.raises(ValueError, match="alloc_tokens"):
            mod.KVCacheSpec(num_layers=1, batch=1, max_tokens=96, num_kv_heads=1,
                            head_dim=8, alloc_tokens=64)


@pytest.mark.parametrize("quant", [False, True])
def test_cache_attention_head_major(quant):
    """`cache_attention` over a head-major padded layer (kv_layout "bhsd",
    logical_kv) equals the token-major call bit for bit and the JAX
    dispatcher's XLA path within 1e-5."""
    rng = np.random.default_rng(22)
    q = rng.standard_normal((1, 9, 2, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 80, 32)).astype(np.float32) for _ in range(2))
    mask = np.arange(80) < 37
    kw, jkw = {}, {}
    if quant:
        ks, vs = (rng.uniform(0.01, 0.1, (1, 2, 80)).astype(np.float32) for _ in range(2))
        k, v = np.round(k * 40).astype(np.int8), np.round(v * 40).astype(np.int8)
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    got = tatt.cache_attention(tq, tk, tv, kv_mask=tm, logical_kv=64, kv_layout="bhsd", **kw)
    tm_kw = {n: x.transpose(1, 2).contiguous() for n, x in kw.items()}
    same = tatt.cache_attention(tq, tk.transpose(1, 2).contiguous(),
                                tv.transpose(1, 2).contiguous(), kv_mask=tm, logical_kv=64,
                                **tm_kw)
    assert torch.equal(got, same)
    want = jatt.cache_attention(*map(jnp.asarray, (q, k, v, mask)), use_pallas=False,
                                logical_kv=64, kv_layout="bhsd", **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="kv_layout"):
        tatt.cache_attention(tq, tk, tv, kv_layout="hbsd")


# --- generation with the switches ---

SWITCHES = {"head_major": dict(kv_head_major=True), "padded": dict(kv_alloc_pad=True),
            "both_int8": dict(kv_head_major=True, kv_alloc_pad=True, int8=True),
            "head_major_e4m3": dict(kv_head_major=True, e4m3=True),
            "padded_ring": dict(kv_alloc_pad=True, ring=True)}


def _configs(switch):
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    sw = dict(SWITCHES[switch])
    int8, e4m3, ring = sw.pop("int8", False), sw.pop("e4m3", False), sw.pop("ring", False)
    for c in (jcfg, tcfg):
        for k, v in sw.items():
            setattr(c.runtime, k, v)
        if int8 or e4m3:
            c.quant.enabled = c.quant.quantize_kv_cache = True
            c.quant.kv_cache_dtype = "fp8" if e4m3 else "int8"
        if ring:
            # a 3-frame ring with 1 sink frame: the 5-block clip wraps
            c.model.local_attn_size, c.model.sink_size = 3, 1
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jp = jax_init_params(jax.random.key(0), jax_tiny_config().model, dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_generate_with_switch(jax_params, switch):
    """A whole clip through `generate` (2 blocks; 5 through the ring) with
    the switch on: latents and cache against the JAX generator with the same
    switch (1e-4; the e4m3 cache 1e-3, a code a rounding apart), and the
    latents bit-equal to the port's own run with the switch off."""
    jcfg, tcfg = _configs(switch)
    jp, tp = jax_params
    jgen = JaxGenerator(jcfg, jp, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, tp, dtype=torch.float32, device="cpu")
    assert tgen.statics.spec.head_major == jgen.statics.spec.head_major
    assert tgen.statics.spec.slots == jgen.statics.spec.slots
    m, r = jcfg.model, jcfg.runtime
    blocks = 5 if "ring" in switch else 2
    rng = np.random.default_rng(23)
    ctx = rng.standard_normal((1, m.text_len, m.text_dim)).astype(np.float32)
    noise = rng.standard_normal((1, blocks, r.latent_height, r.latent_width,
                                 r.latent_channels)).astype(np.float32)
    key = jax.random.key(24)
    jlat, jc = jgen.generate(jnp.asarray(noise), jgen.encode_text_context(jnp.asarray(ctx)), key)
    renoise = []
    for _ in range(blocks):
        key, step = jax.random.split(key)
        renoise.append(_jax_renoise(step, len(jgen.denoising_steps), (1, 1) + noise.shape[2:]))
    tx = tgen.encode_text_context(torch.from_numpy(ctx))
    tlat, tc = tgen.generate(torch.from_numpy(noise), tx, renoise=renoise)
    tol = dict(rtol=1e-3, atol=1e-3) if "e4m3" in switch else TOL
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **tol)
    for t, j in zip(tc, jc):
        if t is not None:
            assert tuple(t.shape) == tuple(j.shape)
            if t.dtype == torch.float32:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
    off = tiny_test_config()
    off.quant, off.model = tcfg.quant, tcfg.model
    base, _ = SemiARGenerator(off, tp, dtype=torch.float32, device="cpu").generate(
        torch.from_numpy(noise), tx, renoise=renoise)
    assert torch.equal(tlat, base)


# --- MAGI ---

def test_magi_walk_with_layouts(trees, injected):
    """The MAGI walk (3-CFG, int8 cache) with both layouts on against the
    JAX walk with both on, and bit-equal to the port's walk with both off."""
    layouts = dict(kv_head_major=True, kv_alloc_pad=True)
    jrt, trt = _runtime(cfg_number=3, quantize_kv=True, **layouts)
    tpipe_ = _port_pipe(trees, trt)
    spec = tpipe_.statics.spec
    assert spec.head_major and spec.slots == 2048 and spec.max_tokens < spec.slots
    got = _walk(tpipe_, trees)
    want = _walk(_jax_pipe(trees, jrt), trees)
    _, trt_off = _runtime(cfg_number=3, quantize_kv=True)
    off = _walk(_port_pipe(trees, trt_off), trees)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(CHUNKS))
    for (_, g), (_, w), (_, o) in zip(got, want, off):
        assert _rel(g, w) <= 2e-2  # the int8 walk's bound (INT8_WALK_RTOL)
        assert np.array_equal(g, o)


def test_jax_head_major_state_resumes_in_port(trees, injected, tmp_path):
    """A JAX walk with the head-major padded cache saves its state after step
    3 (`inferix_tpu.utils.state_checkpoint`); the port loads it and resumes
    with the same layouts: the remaining chunks against the JAX walk's
    (WALK_RTOL). A state in the other layout is refused by name."""
    layouts = dict(cfg_number=1, kv_head_major=True, kv_alloc_pad=True)
    jrt, trt = _runtime(**layouts)
    states = {}

    def keep(state, step):
        states[step] = jax.tree.map(np.asarray, state)

    full = _walk(_jax_pipe(trees, jrt), trees, state_callback=keep)
    path = jax_save_state(str(tmp_path / "magi_hm.npz"), **states[3])
    state = load_generation_state(path, device="cpu")
    assert state["cache"]["k"].shape[2] == trees[0].num_query_groups  # [L, B, Hkv, S, D]
    rest = _walk(_port_pipe(trees, trt), trees, resume_state=state)
    done = len(full) - len(rest)
    assert len(rest) > 0 and done > 0
    for (i, a), (j, b) in zip(rest, full[done:]):
        assert i == j and _rel(a, b) <= WALK_RTOL
    _, trt_tm = _runtime(cfg_number=1)
    with pytest.raises(ValueError, match="layout"):
        _walk(_port_pipe(trees, trt_tm), trees, resume_state=state)


def test_config_keys_taken():
    """runtime.kv_head_major / kv_alloc_pad load from a JAX config's dict
    (no longer dropped) and round-trip."""
    jcfg = jax_tiny_config()
    jcfg.runtime.kv_head_major = jcfg.runtime.kv_alloc_pad = True
    cfg = EngineConfig.from_dict(jcfg.to_dict())
    assert cfg.runtime.kv_head_major and cfg.runtime.kv_alloc_pad
    back = JaxEngineConfig.from_dict(cfg.to_dict())
    assert back.runtime.kv_head_major and back.runtime.kv_alloc_pad
    assert EngineConfig.from_dict(cfg.to_dict()) == cfg
