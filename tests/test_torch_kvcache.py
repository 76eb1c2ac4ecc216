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
