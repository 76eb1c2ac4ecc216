"""The port's KV cache (bf16/f32 token-major cache, global window) against
the JAX package's functional cache. Writes and masks are copies and
comparisons, so the results must be equal, not close."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.kvcache import cache as jcache
from inferix_tpu_torch.kvcache import cache as tcache

L, B, S, H, D = 2, 2, 96, 4, 32


def _specs(dtype=(jnp.float32, torch.float32)):
    return (jcache.KVCacheSpec(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H,
                               head_dim=D, dtype=dtype[0]),
            tcache.KVCacheSpec(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H,
                               head_dim=D, dtype=dtype[1]))


def test_init_kv_cache():
    for dtypes in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jspec, tspec = _specs(dtypes)
        jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
        for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
            assert tuple(a.shape) == tuple(b.shape) == (L, B, S, H, D)
            assert b.dtype == dtypes[1] and not b.any()


@pytest.mark.parametrize("start", [0, 16, 48])
def test_write_block_and_valid_mask(start):
    """Two successive writes into one layer, the second in place over part
    of the first, against the JAX package's write_block; then the mask."""
    jspec, tspec = _specs()
    rng = np.random.default_rng(start)
    jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
    jk, jv = jc.k[1], jc.v[1]
    tk, tv = tc.k[1], tc.v[1]
    for s0, n in ((start, 32), (start + 16, 16)):
        kn = rng.standard_normal((B, n, H, D)).astype(np.float32)
        vn = rng.standard_normal((B, n, H, D)).astype(np.float32)
        jk, jv = jcache.write_block(jspec, jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.int32(s0))
        out = tcache.write_block(tspec, tk, tv, torch.from_numpy(kn),
                                 torch.from_numpy(vn), s0)
        assert out[0] is tk and out[1] is tv  # in place, into the cache itself
        np.testing.assert_array_equal(tc.k[1].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tc.v[1].numpy(), np.asarray(jv))
    assert not tc.k[0].any()  # the other layer is untouched
    assert tcache.position_to_slot(tspec, start + 5) == int(
        jcache.position_to_slot(jspec, jnp.int32(start + 5)))
    for end in (0, start + 32, S, S + 40):
        np.testing.assert_array_equal(tcache.valid_mask(tspec, end, device="cpu").numpy(),
                                      np.asarray(jcache.valid_mask(jspec, jnp.int32(end))))


def test_write_past_the_window_raises():
    _, tspec = _specs()
    tc = tcache.init_kv_cache(tspec, device="cpu")
    new = torch.ones(B, 32, H, D)
    with pytest.raises(ValueError, match="does not fit"):
        tcache.write_block(tspec, tc.k[0], tc.v[0], new, new, S - 16)


# --- the int8 and fp8 caches, the rolling window with sink, [B] starts ---

def _ring_specs(sink, granule, quantized=False, dtype=(jnp.float32, torch.float32)):
    kw = dict(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H, head_dim=D,
              sink_tokens=sink, ring=True, granule=granule, quantized=quantized)
    return (jcache.KVCacheSpec(dtype=dtype[0], **kw),
            tcache.KVCacheSpec(dtype=dtype[1], **kw))


def _block(rng, n, scale=1.0):
    return (rng.standard_normal((B, n, H, D)) * scale).astype(np.float32)


def _assert_fields_equal(tfields, jfields):
    for t, j in zip(tfields, jfields):
        if t.dtype == torch.float8_e4m3fn:
            np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                          np.asarray(j).view(np.uint8))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantize_kv_block_is_exact():
    """Codes equal and scales equal (rtol 0) to the JAX quantizer, an
    all-zero (token, head) row included (the 1e-8 floor)."""
    x = _block(np.random.default_rng(10), 24, scale=3.0)
    x[1, 5, 2] = 0.0
    jq, js = jcache.quantize_kv_block(jnp.asarray(x))
    tq, ts = tcache.quantize_kv_block(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (B, 24, H)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_init_quantized_and_fp8_caches():
    kw = dict(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H, head_dim=D)
    tc = tcache.init_kv_cache(tcache.KVCacheSpec(quantized=True, **kw), device="cpu")
    jc = jcache.init_kv_cache(jcache.KVCacheSpec(quantized=True, **kw))
    for t, j in zip(tc, jc):
        assert tuple(t.shape) == tuple(j.shape) and not t.any()
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    tc = tcache.init_kv_cache(tcache.KVCacheSpec(dtype=torch.float8_e4m3fn, **kw),
                              device="cpu")
    assert tc.k.dtype == torch.float8_e4m3fn and tc.k_scale is None
    assert tuple(tc.v.shape) == (L, B, S, H, D)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_write_and_read(kind):
    """Two writes into one layer of an int8 (4-field) or fp8 cache, in place,
    equal to the JAX cache; fp8 values past +-448 are clipped, not nan."""
    kw = dict(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H, head_dim=D)
    if kind == "int8":
        jspec = jcache.KVCacheSpec(quantized=True, **kw)
        tspec = tcache.KVCacheSpec(quantized=True, **kw)
    else:
        jspec = jcache.KVCacheSpec(dtype=jnp.float8_e4m3fn, **kw)
        tspec = tcache.KVCacheSpec(dtype=torch.float8_e4m3fn, **kw)
    rng = np.random.default_rng(11)
    jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
    jl = [f[1] for f in jc if f is not None]
    tl = [f[1] for f in tc if f is not None]
    for s0, n in ((0, 40), (24, 32)):
        kn, vn = _block(rng, n, 100.0), _block(rng, n, 100.0)
        kn[0, 0, 0, :4] = [1000.0, -1000.0, 448.0, 460.0]
        jl = list(jcache.write_block(jspec, jl[0], jl[1], jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.int32(s0), *jl[2:]))
        out = tcache.write_block(tspec, tl[0], tl[1], torch.from_numpy(kn),
                                 torch.from_numpy(vn), s0, *tl[2:])
        assert len(out) == len(jl) == (4 if kind == "int8" else 2)
        assert all(o is t for o, t in zip(out, tl))  # in place
        _assert_fields_equal([f[1] for f in tc if f is not None], jl)
    if kind == "fp8":
        assert torch.isfinite(tc.k.float()).all()
        assert tc.k[1, 0, 24, 0, :2].float().tolist() == [448.0, -448.0]


@pytest.mark.parametrize("sink", [0, 16])
@pytest.mark.parametrize("n,granule", [(32, 16), (24, 16), (32, 0)])
def test_ring_writes_wrap(sink, n, granule):
    """Successive blocks through a rolling window until it wraps more than
    once: the granule-aligned writes (n a multiple of the granule, one copy
    per granule, wrapping at a granule boundary), the unaligned ones (n =
    24, the general scatter) and granule 0, with and without pinned sink
    slots; float32 and int8 caches against the JAX cache after each write,
    then the slot map and the mask."""
    for quantized in (False, True):
        jspec, tspec = _ring_specs(sink, granule, quantized)
        rng = np.random.default_rng(12 + n + sink)
        jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
        jl = [f[0] for f in jc if f is not None]
        tl = [f[0] for f in tc if f is not None]
        for s0 in range(0, 3 * S, n):
            kn, vn = _block(rng, n), _block(rng, n)
            jl = list(jcache.write_block(jspec, jl[0], jl[1], jnp.asarray(kn),
                                         jnp.asarray(vn), jnp.int32(s0), *jl[2:]))
            tcache.write_block(tspec, tl[0], tl[1], torch.from_numpy(kn),
                               torch.from_numpy(vn), s0, *tl[2:])
            _assert_fields_equal(tl, jl)
    for pos in (0, sink, S - 1, S, S + 7, 3 * S + 5):
        assert tcache.position_to_slot(tspec, pos) == int(
            jcache.position_to_slot(jspec, jnp.int32(pos)))
    pos = torch.arange(0, 3 * S)
    np.testing.assert_array_equal(tcache.position_to_slot(tspec, pos).numpy(),
                                  np.asarray(jcache.position_to_slot(jspec, jnp.arange(3 * S))))
    for end in (0, 40, S, 2 * S + 8):
        np.testing.assert_array_equal(tcache.valid_mask(tspec, end, device="cpu").numpy(),
                                      np.asarray(jcache.valid_mask(jspec, jnp.int32(end))))


@pytest.mark.parametrize("ring", [False, True])
def test_per_row_starts_and_mask(ring):
    """[B] starts (each stream at its own block) and the [B, S] mask, in the
    global window and in a ring that one row wraps, int8 cache."""
    if ring:
        jspec, tspec = _ring_specs(16, 16, quantized=True)
        starts = [32, 112]
    else:
        kw = dict(num_layers=L, batch=B, max_tokens=S, num_kv_heads=H, head_dim=D,
                  quantized=True)
        jspec, tspec = jcache.KVCacheSpec(**kw), tcache.KVCacheSpec(**kw)
        starts = [16, 48]
    rng = np.random.default_rng(13)
    jc, tc = jcache.init_kv_cache(jspec), tcache.init_kv_cache(tspec, device="cpu")
    jl, tl = [f[0] for f in jc], [f[0] for f in tc]
    kn, vn = _block(rng, 32), _block(rng, 32)
    jl = jcache.write_block(jspec, jl[0], jl[1], jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(starts, jnp.int32), *jl[2:])
    tcache.write_block(tspec, tl[0], tl[1], torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.tensor(starts), *tl[2:])
    _assert_fields_equal(tl, jl)
    ends = [s + 32 for s in starts]
    np.testing.assert_array_equal(
        tcache.valid_mask(tspec, torch.tensor(ends), device="cpu").numpy(),
        np.asarray(jcache.valid_mask(jspec, jnp.asarray(ends, jnp.int32))))
