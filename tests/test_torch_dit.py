"""The port's causal DiT against the JAX package's, at tiny_test_config sizes
in float32 on the CPU, from the same parameters (JAX's init_params, carried
across with params_from_numpy) and the same numpy inputs.

Tolerance 1e-5 for the embeddings; 1e-4 (absolute and relative) for a layer
and for whole forwards, whose outputs are O(1) sums of O(1e3) float32
products taken in other orders by the two frameworks, over 2 layers.
"""
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
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.kvcache.cache import init_kv_cache, valid_mask
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops.rope import build_rope_tables, rope_angles
from inferix_tpu_torch.utils.params import init_params, params_from_numpy

EMB_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return jcfg, tcfg, jp, tp


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_params_from_numpy_bf16(fused):
    """A bf16 JAX tree, stacked and unfused or fused: every value carried
    exactly, float32 kept where the JAX package keeps it."""
    cfg = jax_tiny_config()
    jp = jdit.init_params(jax.random.key(1), cfg.model, dtype=jnp.bfloat16)
    if fused:
        jp = jdit.fuse_qkv_params(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    jf, tf = _flat(jp), _flat(tp)
    assert jf.keys() == tf.keys()
    for name, a in jf.items():
        want_dtype = torch.float32 if a.dtype == jnp.float32 else torch.bfloat16
        assert tf[name].dtype == want_dtype, name
        np.testing.assert_array_equal(tf[name].float().numpy(),
                                      np.asarray(a, np.float32), err_msg=name)


def test_fuse_qkv_params(setup):
    _, _, jp, tp = setup
    jf, tf = _flat(jdit.fuse_qkv_params(jp)), _flat(tdit.fuse_qkv_params(tp))
    assert jf.keys() == tf.keys()
    for name in jf:
        np.testing.assert_array_equal(_np(tf[name]), np.asarray(jf[name]), err_msg=name)


def test_init_params_layout_and_distributions():
    """The port's own init: the JAX tree's keys, shapes and dtypes, with
    the same distributions (uniform in +-1/sqrt(in), zero biases, unit norm
    weights, modulation N(0, 1/dim))."""
    jcfg, tcfg = jax_tiny_config(), tiny_test_config()
    jf = _flat(jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.bfloat16))
    tf = _flat(init_params(tcfg.model, torch.Generator().manual_seed(0), device="cpu"))
    assert jf.keys() == tf.keys()
    for name, a in jf.items():
        t = tf[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == (torch.float32 if a.dtype == jnp.float32 else torch.bfloat16), name
        if name.endswith("/w") and t.dim() >= 2 and "norm" not in name:
            bound = t.shape[-2] ** -0.5
            assert t.float().abs().max() <= bound and t.float().std() > 0.5 * bound / 3 ** 0.5
        elif name.endswith("/b"):
            assert not t.any()
        elif "norm" in name:
            assert (t == 1).all()
        else:  # modulation
            assert abs(t.std().item() * tcfg.model.dim ** 0.5 - 1) < 0.2


def test_embeddings_and_text_cache(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    t = np.array([[999.0, 250.0]], np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    tok = tdit.patch_embed(tp, tcfg.model, torch.from_numpy(x))
    np.testing.assert_allclose(_np(tok), np.asarray(jdit.patch_embed(jp, jcfg.model, x)),
                               **EMB_TOL)
    geo = tdit.DiTGeometry(2, 8, 8, tcfg.model.patch_size)
    jgeo = jdit.DiTGeometry(2, 8, 8, jcfg.model.patch_size)
    y = rng.standard_normal((1, geo.tokens, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tdit.unpatchify(torch.from_numpy(y), tcfg.model, geo)),
        np.asarray(jdit.unpatchify(jnp.asarray(y), jcfg.model, jgeo)))
    for a, b in zip(tdit.time_embeddings(tp, tcfg.model, torch.from_numpy(t)),
                    jdit.time_embeddings(jp, jcfg.model, jnp.asarray(t))):
        np.testing.assert_allclose(_np(a), np.asarray(b), **EMB_TOL)
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
    for a, b in ((tx.k, jx.k), (tx.v, jx.v)):
        assert tuple(a.shape) == b.shape == (2, 1, 16, 4, 32)
        np.testing.assert_allclose(_np(a), np.asarray(b), **EMB_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_block_forward(setup, fused):
    """One layer over a cache that already holds one frame: output and the
    written cache layer."""
    jcfg, tcfg, jp, tp = setup
    if fused:
        jp, tp = jdit.fuse_qkv_params(jp), tdit.fuse_qkv_params(tp)
    rng = np.random.default_rng(1)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    fs = js.geo.frame_seq
    x = rng.standard_normal((1, fs, 128)).astype(np.float32)
    e0 = rng.standard_normal((1, 1, 6, 128)).astype(np.float32) * 0.1
    prior = rng.standard_normal((2, 1, fs, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    jc = jax_init_kv_cache(js.spec)
    jk, jv = jc.k[0].at[:, :fs].set(prior[0]), jc.v[0].at[:, :fs].set(prior[1])
    tc = init_kv_cache(ts.spec, device="cpu")
    tc.k[0][:, :fs] = torch.from_numpy(prior[0])
    tc.v[0][:, :fs] = torch.from_numpy(prior[1])
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"])
    jang = jax_rope_angles(jax_rope_tables(32, 64), 1, 4, 4, 1)
    tang = rope_angles(build_rope_tables(32, 64, device="cpu"), 1, 4, 4, 1)
    jy, (jk, jv) = jdit.block_forward(
        jblock, jcfg.model, js.spec, jnp.asarray(x), jnp.asarray(e0), jang, (jk, jv),
        jx.k[0], jx.v[0], None, jnp.int32(fs), jax_valid_mask(js.spec, jnp.int32(2 * fs)))
    ty, (tk, tv) = tdit.block_forward(
        tdit.layer_params(tp["blocks"], 0), tcfg.model, ts.spec, torch.from_numpy(x),
        torch.from_numpy(e0), tang, (tc.k[0], tc.v[0]), tx.k[0], tx.v[0], fs,
        valid_mask(ts.spec, 2 * fs, device="cpu"))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(_np(tc.k[0]), np.asarray(jk), **FWD_TOL)
    np.testing.assert_allclose(_np(tc.v[0]), np.asarray(jv), **FWD_TOL)


def test_forward_then_two_cached_forwards(setup):
    """dit_forward_inference over frames 0, 1, 2 in turn, each attending over
    the cache the earlier ones wrote: flows and the whole cache after each."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx))
    jt, tt = jax_rope_tables(32, 64), build_rope_tables(32, 64, device="cpu")
    jc, tc = jax_init_kv_cache(js.spec), init_kv_cache(ts.spec, device="cpu")
    fs = js.geo.frame_seq
    for i, tval in enumerate((999.0, 500.0, 0.0)):
        x = rng.standard_normal((1, 1, 8, 8, 16)).astype(np.float32)
        t = np.full((1, 1), tval, np.float32)
        jflow, jc = jdit.dit_forward_inference(jp, js, jt, jnp.asarray(x), jnp.asarray(t),
                                               jx, jc, jnp.int32(i * fs))
        tflow, tc = tdit.dit_forward_inference(tp, ts, tt, torch.from_numpy(x),
                                               torch.from_numpy(t), tx, tc, i * fs)
        np.testing.assert_allclose(_np(tflow), np.asarray(jflow), **FWD_TOL)
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **FWD_TOL)
        np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **FWD_TOL)
    # the context re-run form on the same block: no head, flow None, and the
    # cache rewritten with the same values (each layer writes its block's
    # slots before it reads them)
    k_before, v_before = tc.k.clone(), tc.v.clone()
    flow, _ = tdit.dit_forward_inference(tp, ts, tt, torch.from_numpy(x),
                                         torch.from_numpy(t), tx, tc, 2 * fs,
                                         need_output=False)
    assert flow is None
    assert torch.equal(tc.k, k_before) and torch.equal(tc.v, v_before)
