"""The DiT's i2v branch against the JAX package's, at tiny_test_config sizes
(model_type "i2v", in_dim 36) in float32 on the CPU: the parameter tree
(`init_params`, the bridge), `precompute_crossattn_cache` with CLIP features
(`img_emb`, each layer's k_img / v_img), forwards over the cache with the
image attention added to the text attention, and W8A8's quantized set
(`quantize_params` matches paths by substring, so `cross_attn/k_img` and
`cross_attn/v_img` are int8 linears in both packages; `img_emb` and
`norm_k_img` are not).

Tolerances: the tests/test_torch_dit.py ones (1e-5 for the embeddings and
the cross-attention cache, 1e-4 for forwards), and tests/test_torch_w8a8.py's
1e-3 in norm for the W8A8 forward.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.kvcache.cache import init_kv_cache as jax_init_kv_cache
from inferix_tpu.models.wan import causal_dit as jdit
from inferix_tpu.ops.rope import build_rope_tables as jax_rope_tables
from inferix_tpu.quant import api as japi
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.kvcache.cache import init_kv_cache
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops.rope import build_rope_tables
from inferix_tpu_torch.quant import api as tapi
from inferix_tpu_torch.utils.params import init_params, params_from_numpy

EMB_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
W8A8_RTOL = 1e-3
CLIP_TOKENS = 17


def _i2v(cfg):
    cfg.model.model_type = "i2v"
    cfg.model.in_dim = 36
    return cfg


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _i2v(jax_tiny_config()), _i2v(tiny_test_config())
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    clip = rng.standard_normal((1, CLIP_TOKENS, 1280)).astype(np.float32)
    return jcfg, tcfg, jp, tp, ctx, clip


def test_init_params_i2v_tree():
    """The port's i2v init: the JAX tree's keys, shapes and dtypes (img_emb,
    k_img / v_img / norm_k_img in every block), and the bridge carries a
    JAX i2v tree whole."""
    jcfg, tcfg = _i2v(jax_tiny_config()), _i2v(tiny_test_config())
    jp = jdit.init_params(jax.random.key(0), jcfg.model, dtype=jnp.bfloat16)
    jf = _flat(jp)
    tf = _flat(init_params(tcfg.model, torch.Generator().manual_seed(0), device="cpu"))
    assert jf.keys() == tf.keys()
    assert {"img_emb/fc1/w", "blocks/cross_attn/k_img/w", "blocks/cross_attn/norm_k_img/w"} <= set(tf)
    for name, a in jf.items():
        assert tuple(tf[name].shape) == a.shape, name
        assert tf[name].dtype == (torch.float32 if a.dtype == jnp.float32
                                  else torch.bfloat16), name
    bridged = _flat(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16))
    assert bridged.keys() == jf.keys()
    for name, a in jf.items():
        np.testing.assert_array_equal(bridged[name].float().numpy(),
                                      np.asarray(a.astype(jnp.float32)), err_msg=name)
    with pytest.raises(ValueError, match="model_type"):
        tcfg.model.model_type = "v2v"
        init_params(tcfg.model, torch.Generator(), device="cpu")


def test_crossattn_cache_with_clip_features(setup):
    jcfg, tcfg, jp, tp, ctx, clip = setup
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx),
                                         clip_features=jnp.asarray(clip))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx),
                                         clip_features=torch.from_numpy(clip))
    for a, b in ((tx.k, jx.k), (tx.v, jx.v), (tx.k_img, jx.k_img), (tx.v_img, jx.v_img)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), **EMB_TOL)
    assert tuple(tx.k_img.shape) == (2, 1, CLIP_TOKENS, 4, 32)
    # without features, or for a t2v model, there is no image K/V
    assert tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx)).k_img is None


def test_i2v_forwards(setup):
    """dit_forward_inference on 36-channel inputs over frames 0 and 1, the
    second attending over the first's cache: flows and caches; the image
    attention moves the output."""
    jcfg, tcfg, jp, tp, ctx, clip = setup
    rng = np.random.default_rng(1)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg.model, jnp.asarray(ctx),
                                         clip_features=jnp.asarray(clip))
    tx = tdit.precompute_crossattn_cache(tp, tcfg.model, torch.from_numpy(ctx),
                                         clip_features=torch.from_numpy(clip))
    jt, tt = jax_rope_tables(32, 64), build_rope_tables(32, 64, device="cpu")
    jc, tc = jax_init_kv_cache(js.spec), init_kv_cache(ts.spec, device="cpu")
    fs = js.geo.frame_seq
    for i, tval in enumerate((999.0, 0.0)):
        x = rng.standard_normal((1, 1, 8, 8, 36)).astype(np.float32)
        t = np.full((1, 1), tval, np.float32)
        jflow, jc = jdit.dit_forward_inference(jp, js, jt, jnp.asarray(x), jnp.asarray(t),
                                               jx, jc, jnp.int32(i * fs))
        tflow, tc = tdit.dit_forward_inference(tp, ts, tt, torch.from_numpy(x),
                                               torch.from_numpy(t), tx, tc, i * fs)
        assert tuple(tflow.shape) == (1, 1, 8, 8, 16)
        np.testing.assert_allclose(_np(tflow), np.asarray(jflow), **FWD_TOL)
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), **FWD_TOL)
        np.testing.assert_allclose(_np(tc.v), np.asarray(jc.v), **FWD_TOL)
    text_only = tx._replace(k_img=None, v_img=None)
    flow2, _ = tdit.dit_forward_inference(tp, ts, tt, torch.from_numpy(x),
                                          torch.from_numpy(t), text_only,
                                          init_kv_cache(ts.spec, device="cpu"), fs)
    assert not torch.allclose(flow2, tflow, atol=1e-3)


def _w8a8(cfg):
    cfg.quant.enabled = True
    return cfg


def test_w8a8_quantizes_the_jax_set(setup):
    """quantize_params on an i2v tree: the same leaves quantized as the JAX
    package quantizes (k_img and v_img among them), with equal codes and
    scales; img_emb and norm_k_img stay float."""
    jcfg, tcfg, jp, tp, _, _ = setup
    jq = _flat(japi.quantize_params(jp, _w8a8(jax_tiny_config()).quant))
    tq = _flat(tapi.quantize_params(tp, _w8a8(tiny_test_config()).quant))
    assert jq.keys() == tq.keys()
    quantized = {k.rsplit("/", 1)[0] for k in tq if k.endswith("/w_q")}
    assert {k.rsplit("/", 1)[0] for k in jq if k.endswith("/w_q")} == quantized
    assert {"blocks/cross_attn/k_img", "blocks/cross_attn/v_img"} <= quantized
    assert not any(k.startswith("img_emb") for k in quantized)
    assert "blocks/cross_attn/norm_k_img/w" in tq
    for k in tq:
        np.testing.assert_array_equal(_np(tq[k]).astype(np.float32),
                                      np.asarray(jq[k]).astype(np.float32), err_msg=k)


@contextlib.contextmanager
def _jax_fused():
    """The JAX package's fused act-quant in interpret mode (its CPU path
    otherwise takes the XLA chain; see tests/test_torch_w8a8.py)."""
    japi.set_fused_act_quant(True, interpret=True)
    try:
        yield
    finally:
        japi.set_fused_act_quant(False)


def test_w8a8_i2v_forward(setup):
    """A W8A8 i2v forward (the k_img / v_img projections through the int8
    linear) against the JAX one with its fused act-quant."""
    jcfg, tcfg, jp, tp, ctx, clip = setup
    jq = japi.quantize_params(jp, _w8a8(jax_tiny_config()).quant)
    tq = tapi.to_kernel_layout(tdit.fuse_qkv_params(
        params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.float32)))
    jq = jdit.fuse_qkv_params(jq)
    js = jdit.make_statics(jcfg.model, 1, 1, 8, 8, jnp.float32)
    ts = tdit.make_statics(tcfg.model, 1, 1, 8, 8, torch.float32)
    x = np.random.default_rng(2).standard_normal((1, 1, 8, 8, 36)).astype(np.float32)
    t = np.full((1, 1), 500.0, np.float32)
    with _jax_fused():
        jx = jdit.precompute_crossattn_cache(jq, jcfg.model, jnp.asarray(ctx),
                                             clip_features=jnp.asarray(clip))
        jflow, _ = jdit.dit_forward_inference(jq, js, jax_rope_tables(32, 64),
                                              jnp.asarray(x), jnp.asarray(t), jx,
                                              jax_init_kv_cache(js.spec), jnp.int32(0))
    tx = tdit.precompute_crossattn_cache(tq, tcfg.model, torch.from_numpy(ctx),
                                         clip_features=torch.from_numpy(clip))
    tflow, _ = tdit.dit_forward_inference(tq, ts, build_rope_tables(32, 64, device="cpu"),
                                          torch.from_numpy(x), torch.from_numpy(t), tx,
                                          init_kv_cache(ts.spec, device="cpu"), 0)
    for a, b in ((tx.k_img, jx.k_img), (tx.v_img, jx.v_img), (tflow, jflow)):
        err = np.linalg.norm(_np(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))
        assert err <= W8A8_RTOL, err
