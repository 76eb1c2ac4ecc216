"""The port's MAGI-1 DiT parts against the JAX package's, float32, on the
CPU: one layer, the linears in each form, the learned rope, the GQA
attention wrappers (against the JAX wrappers in interpret mode),
`split_gated_fc1`, the statics and their refusals, and the initialiser's
tree. Trees, inputs and tolerances: tests/test_torch_magi.py, which holds
the forwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.kvcache.cache import init_kv_cache as jax_init_cache
from inferix_tpu.models.magi import dit as jdit
from inferix_tpu.ops import flash_attention as jfa
from inferix_tpu.quant import api as japi
from inferix_tpu_torch.kvcache.cache import init_kv_cache
from inferix_tpu_torch.models.magi import dit as tdit
from inferix_tpu_torch.ops import flash_attention as tfa
from inferix_tpu_torch.utils.params import params_from_numpy

from test_torch_magi import (E4M3_RTOL, LH, LW, MAX_CHUNKS, SELF_TOL, W8A8_LAYER_RTOL,
                             _cfgs, _check, _inputs, _np, _rel, _statics, _trees,
                             fused_jax)  # noqa: F401 (a fixture)


def test_magi_layer_matches_jax(fused_jax):
    """One `_magi_layer` of the W8A8 24B-shaped tree over a float32 cache:
    the layer's output and the K/V it wrote, to W8A8_LAYER_RTOL."""
    jcfg, tcfg, jp, tp = _trees("24b_int8")
    js, ts = _statics(jcfg, tcfg, 1, "model")
    jc, tc = jax_init_cache(js.spec), init_kv_cache(ts.spec, "cpu")
    rng = np.random.default_rng(4)
    ct = ts.geo.chunk_tokens
    h = rng.standard_normal((1, 2 * ct, jcfg.hidden_size)).astype(np.float32)
    cond = rng.standard_normal((1, 2, jcfg.cond_dim)).astype(np.float32)
    y = rng.standard_normal((1, 2, jcfg.caption_max_length, jcfg.xattn_dim)).astype(np.float32)
    cmask = np.ones((1, 2, jcfg.caption_max_length), np.float32)
    cmask[..., -3:] = 0
    ang = np.array(jdit.magi_rope_angles(jp["rope_bands"], 6, 4, 4))[ct:3 * ct]
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"])
    jh, jcache = jdit._magi_layer(
        jblk, jnp.asarray(h), jnp.asarray(cond), jnp.asarray(y), jnp.asarray(cmask),
        (jc.k[0], jc.v[0]), cfg=jcfg, spec=js.spec, n_chunks=2, ct=ct,
        angles=jnp.asarray(ang), token_ranges=jnp.asarray([[0, ct], [0, 3 * ct]]),
        current_start=jnp.int32(ct), current_end=jnp.int32(3 * ct))
    th = tdit._magi_layer(
        tdit.layer_params(tp["blocks"], 0), torch.from_numpy(h), torch.from_numpy(cond),
        torch.from_numpy(y), torch.from_numpy(cmask), (tc.k[0], tc.v[0]), cfg=tcfg,
        spec=ts.spec, n_chunks=2, ct=ct, angles=torch.from_numpy(ang),
        token_ranges=[(0, ct), (0, 3 * ct)], current_start=ct, current_end=3 * ct)
    _check("layer", th, jh, "24b_int8", "model", rtol=W8A8_LAYER_RTOL)
    for a, b in zip((tc.k[0], tc.v[0]), jcache):
        _check("layer cache", a, b, "24b_int8", "model", rtol=W8A8_LAYER_RTOL)


@pytest.mark.parametrize("kind", ["24b", "24b_int8"])
def test_split_gated_fc1(kind):
    """`split_gated_fc1` gives views of the concatenated leaves and the same
    forward: bit-equal under W8A8 (the same codes through the same GEMM,
    the silu in the act-quant pass's arithmetic), 1e-5 in float32."""
    _, tcfg, _, tp = _trees(kind)
    split = tdit.split_gated_fc1(tp, tcfg.ffn_hidden_size)
    fc1, gate, up = tp["blocks"]["fc1"], split["blocks"]["fc1"], split["blocks"]["fc1_up"]
    for name, leaf in fc1.items():
        assert torch.equal(torch.cat([gate[name], up[name]], -1), leaf)
    assert tdit.split_gated_fc1(split, tcfg.ffn_hidden_size)["blocks"] is split["blocks"]
    ts = tdit.make_magi_statics(tcfg, 1, LH, LW, MAX_CHUNKS, torch.float32)
    x, t, cap, cmask = _inputs(tcfg, 1, 2, 5)
    outs = []
    for tree in (tp, split):
        v, c = tdit.magi_forward(tree, ts, None, torch.from_numpy(x), t,
                                 torch.from_numpy(cap), cmask,
                                 init_kv_cache(ts.spec, "cpu"), 0, [[0, 1], [0, 2]])
        outs.append((v, c))
    if kind.endswith("int8"):
        assert torch.equal(outs[0][0], outs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1])
                   if a is not None)
    else:
        torch.testing.assert_close(outs[1][0], outs[0][0], **SELF_TOL)


def test_split_gated_fc1_matches_jax():
    """The split tree, leaf for leaf, against the JAX transform's."""
    jcfg, tcfg, jp, tp = _trees("24b_int8")
    js = jdit.split_gated_fc1(jp, jcfg.ffn_hidden_size)
    ts = tdit.split_gated_fc1(tp, tcfg.ffn_hidden_size)
    for key in ("fc1", "fc1_up"):
        for name in js["blocks"][key]:
            np.testing.assert_array_equal(_np(ts["blocks"][key][name]),
                                          np.asarray(js["blocks"][key][name]))


@pytest.mark.parametrize("t_total,gh,gw", [(4, 4, 4), (3, 16, 16), (2, 45, 45), (1, 5, 9)])
def test_rope_matches_jax(t_total, gh, gw):
    """`magi_rope_angles` (centered, ref-shape-rescaled coords) and
    `apply_rope_magi` on [B, S, H, D] with a pass-through tail."""
    rng = np.random.default_rng(gh)
    bands = (np.asarray(jdit.default_rope_bands(32))
             * (1 + 0.1 * rng.standard_normal(4))).astype(np.float32)
    np.testing.assert_allclose(_np(tdit.default_rope_bands(32, device="cpu")),
                               np.asarray(jdit.default_rope_bands(32)), rtol=1e-6)
    ja = np.array(jdit.magi_rope_angles(jnp.asarray(bands), t_total, gh, gw))
    ta = tdit.magi_rope_angles(torch.from_numpy(bands), t_total, gh, gw)
    np.testing.assert_allclose(_np(ta), ja, rtol=1e-6, atol=1e-5)
    s = min(ja.shape[0], 64)
    x = rng.standard_normal((2, s, 3, 32)).astype(np.float32)
    jx = jdit.apply_rope_magi(jnp.asarray(x), jnp.asarray(ja[:s]))
    tx = tdit.apply_rope_magi(torch.from_numpy(x), torch.from_numpy(ja[:s]))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(tx)[..., 24:], x[..., 24:])


def _fp8_linear_tree(rng, per_channel, k=128, n=64):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    ws = np.float32(np.abs(w).max() / 448.0)
    tree = {"w_q": (w / ws).astype(jnp.float8_e4m3fn), "weight_scale": ws}
    if per_channel:
        tree["smooth_scale"] = (rng.uniform(0.75, 1.25, k)).astype(np.float32)
        tree["input_scale"] = np.float32(0.02)
    else:
        tree["act_scale"] = np.full(k, 0.02, np.float32)
    return tree


@pytest.mark.parametrize("form", ["plain", "plain_bias", "fp8_tensor", "fp8_channel",
                                  "int8", "int8_gelu_exact", "int8_silu_mul"])
def test_magi_linear_matches_jax(form, fused_jax):
    """`magi_linear` in each form, and `magi_int8_linear` with each folded
    activation: float32 forms to 1e-5; the fp8 forms (e4m3 activations) to
    E4M3_RTOL in norm, the int8 forms to 1e-6 in norm; the int8 linear
    adds no bias, as in JAX."""
    rng = np.random.default_rng(len(form))
    x = (rng.standard_normal((3, 5, 128)) * 3).astype(np.float32)
    if form.startswith("plain"):
        p = {"w": rng.standard_normal((128, 64)).astype(np.float32) * 0.1}
        if form == "plain_bias":
            p["b"] = rng.standard_normal(64).astype(np.float32)
    elif form.startswith("fp8"):
        p = _fp8_linear_tree(rng, form == "fp8_channel")
    else:
        k_in = 256 if form == "int8_silu_mul" else 128
        x = (rng.standard_normal((3, 5, k_in)) * 3).astype(np.float32)
        w = jnp.asarray(rng.standard_normal((128, 64)).astype(np.float32))
        p = jax.tree.map(np.asarray, japi.magi_quantize_params_int8(
            {"blocks": {"fc2": {"w": w, "b": jnp.ones(64)}}})["blocks"]["fc2"])
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu", torch.float32)
    if form.startswith("int8"):
        act = {"int8": None, "int8_gelu_exact": "gelu_exact",
               "int8_silu_mul": "silu_mul"}[form]
        want = jdit.magi_int8_linear(jp, jnp.asarray(x), act=act)
        got = tdit.magi_int8_linear(tp, torch.from_numpy(x), act=act)
        if act is None:
            np.testing.assert_array_equal(_np(tdit.magi_linear(tp, torch.from_numpy(x))),
                                          _np(got))
        err = _rel(got, want)
        assert err <= 1e-6, err
        return
    want = jdit.magi_linear(jp, jnp.asarray(x))
    got = tdit.magi_linear(tp, torch.from_numpy(x))
    if form.startswith("fp8"):
        assert _rel(got, want) <= E4M3_RTOL
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_qdq_e4m3_saturates():
    """Values past +-448 clip to +-448 before the cast (torch's cast to
    e4m3fn gives nan there), as the JAX `_qdq_e4m3`."""
    x = np.asarray([-1000.0, -448.0, -3.3, 0.0, 1e-4, 17.0, 449.0, 5e4], np.float32)
    got = tdit._qdq_e4m3(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(jdit._qdq_e4m3(jnp.asarray(x))))
    assert got[0] == -448.0 and got[-1] == 448.0


@pytest.mark.parametrize("rep", [2, 3])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_gqa_wrappers_match_jax_interpret(rep, kv):
    """The port's GQA fold over the plain prefix versions against the JAX
    wrappers over the Pallas kernels in interpret mode: two batch rows with
    their own span [kv_start > 0, kv_len), and lse for bf16 K/V."""
    rng = np.random.default_rng(rep)
    b, sq, hkv, d, skv = 2, 24, 2, 128, 256
    q = (rng.standard_normal((b, sq, hkv * rep, d)) * 0.3).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    start, end = np.asarray([16, 0], np.int32), np.asarray([200, 129], np.int32)
    if kv == "bf16":
        k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (k, v))
        jo, jl = jfa.flash_attention_gqa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(end),
            jnp.asarray(start), return_lse=True, interpret=True, q_block=16, kv_block=128)
        to, tl = tfa.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), torch.from_numpy(end),
                                         torch.from_numpy(start), return_lse=True)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=2e-5, atol=2e-5)
        return
    kq = rng.integers(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.01, (b, skv, hkv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.01, (b, skv, hkv)).astype(np.float32)
    jo = jfa.flash_attention_gqa_quant(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(end), jnp.asarray(start), interpret=True, q_block=16, kv_block=128)
    to = tfa.flash_attention_gqa_quant(*(torch.from_numpy(a) for a in (q, kq, vq, ks, vs)),
                                       kv_len=torch.from_numpy(end),
                                       kv_start=torch.from_numpy(start))
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=2.0 ** -8, atol=2.0 ** -8)
    with pytest.raises(NotImplementedError, match="return_lse"):
        tfa.flash_attention_gqa_quant(*(torch.from_numpy(a) for a in (q, kq, vq, ks, vs)),
                                      kv_len=200, return_lse=True)


def test_gqa_fold_rep1_and_layout():
    """rep 1 goes straight to the prefix call; the fold puts head g*rep + r
    at rows r*Sq .. of kv head g, and unfolds back exactly; a head count
    that does not group is refused."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 5, 6, 8)).astype(np.float32))
    f = tfa.gqa_fold(q, 2)
    assert f.shape == (1, 15, 2, 8) and f.is_contiguous()
    assert torch.equal(f[:, 1 * 5 + 3, 1], q[:, 3, 1 * 3 + 1])
    assert torch.equal(tfa.gqa_unfold(f, 5), q)
    k = torch.from_numpy(rng.standard_normal((1, 9, 6, 8)).astype(np.float32))
    torch.testing.assert_close(tfa.flash_attention_gqa(q, k, k, 9),
                               tfa.flash_attention_prefix(q, k, k, 9), rtol=0, atol=0)
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention_gqa(q, k[:, :, :4], k[:, :, :4], 9)


@pytest.mark.parametrize("kw,exc,match", [
    # since A13b a mesh is taken: an object that is none is refused, and an
    # island without a mesh of sp or tp > 1 raises ValueError, as in JAX
    pytest.param(dict(mesh=object()), TypeError, "mesh",
                 id="kw0-NotImplementedError-A13"),
    pytest.param(dict(sp_mode="cso"), ValueError, "requires a mesh",
                 id="kw1-NotImplementedError-A13"),
    pytest.param(dict(sp_mode="ulysses"), ValueError, "requires a mesh",
                 id="kw2-NotImplementedError-A13"),
    (dict(sp_mode="ring"), ValueError, "sp_mode"),
])
def test_make_magi_statics_refusals(kw, exc, match):
    _, tcfg = _cfgs("tiny")
    with pytest.raises(exc, match=match):
        tdit.make_magi_statics(tcfg, 1, LH, LW, MAX_CHUNKS, torch.float32, **kw)


@pytest.mark.parametrize("kw", [dict(kv_head_major=True), dict(kv_alloc_multiple=2048)])
def test_make_magi_statics_layouts(kw):
    """The cache layouts are taken (no longer refused): the spec's layout
    fields and the initialised cache's shapes equal the JAX package's."""
    jcfg, tcfg = _cfgs("tiny")
    js = jdit.make_magi_statics(jcfg, 2, LH, LW, MAX_CHUNKS, jnp.float32, quantize_kv=True, **kw)
    ts = tdit.make_magi_statics(tcfg, 2, LH, LW, MAX_CHUNKS, torch.float32, quantize_kv=True,
                                **kw)
    for f in ("max_tokens", "alloc_tokens", "slots", "head_major"):
        assert getattr(ts.spec, f) == getattr(js.spec, f), f
    for t, j in zip(init_kv_cache(ts.spec, device="cpu"), jax_init_cache(js.spec)):
        assert tuple(t.shape) == tuple(j.shape)


def test_make_magi_statics_matches_jax():
    """Geometry and cache spec of the 4.5B reference window (4 chunks at
    720x720) and the tiny one, against the JAX statics."""
    for jcfg, shape in ((jdit.MagiModelConfig(), (90, 90)), (jdit.tiny_magi_config(), (LH, LW))):
        tcfg = tdit.MagiModelConfig(**dataclasses.asdict(jcfg))
        js = jdit.make_magi_statics(jcfg, 2, *shape, 4, jnp.bfloat16, quantize_kv=True)
        ts = tdit.make_magi_statics(tcfg, 2, *shape, 4, torch.bfloat16, quantize_kv=True)
        assert dataclasses.asdict(ts.geo) == dataclasses.asdict(js.geo)
        for f in ("num_layers", "batch", "max_tokens", "num_kv_heads", "head_dim", "quantized"):
            assert getattr(ts.spec, f) == getattr(js.spec, f), f
        assert ts.spec.dtype == torch.bfloat16
    assert ts.geo.chunk_tokens == 2 * 4 * 4
    big = tdit.make_magi_statics(tdit.MagiModelConfig(), 1, 90, 90, 4)
    assert big.geo.chunk_tokens == 12150 and big.spec.max_tokens == 48600


def test_init_magi_params_tree_matches_jax():
    """The port's seeded initialiser gives the JAX tree's paths, shapes and
    dtypes (bf16 model, float32 where JAX keeps float32), and its weights'
    scale (std ~ 1/sqrt(in))."""
    for name in ("tiny", "24b"):
        jcfg, tcfg = _cfgs(name)
        jt = jdit.init_magi_params(jax.random.key(0), jcfg, jnp.bfloat16)
        tt = tdit.init_magi_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        jl = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(jt)}
        tl = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + f"['{k}']")
            else:
                tl[path] = node

        walk(tt, "")
        assert set(tl) == set(jl)
        for path, a in jl.items():
            assert tuple(tl[path].shape) == a.shape, path
            assert str(tl[path].dtype).split(".")[-1] == a.dtype.name, path
        w = tt["blocks"]["fc1"]["w"].float()
        assert abs(float(w.std()) * jcfg.hidden_size ** 0.5 - 1) < 0.05
