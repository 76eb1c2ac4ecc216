"""The port's W8A8 modules against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both. The JAX side runs
its Pallas kernels in interpret mode; the port's wrappers take their plain
versions on CPU tensors. Tolerances, each with its reason:
- the quantizers, the int8 GEMM's plain version, act=None quantization and
  the bf16 LN + modulate prologue repeat the JAX arithmetic (the XLA chain
  of the JAX package) exactly: codes equal, scales with rtol 0, GEMM outputs
  (f32) within 1e-6;
- the Pallas kernels in interpret mode on the CPU do not quite compute their
  own source's arithmetic: the interpreter takes absmax / 127 as
  absmax * (1/127), so a row's scale may sit 1 f32 ulp away (and its codes
  +-1), and in bf16 the LN + modulate kernel differs from the JAX package's
  own unfused chain (layer_norm + _modulate + quant) in ~5% of the codes,
  by 1. Against the interpreter the port is held to codes within +-1 and
  scales within 1 ulp (act None) or 2^-7 relative (bf16 modulate, one bf16
  ulp of the row's absmax), with the share of codes that differ printed;
- with an activation folded in, the two sides compute tanh / exp / the
  sigmoid with other implementations (ulps apart), and a value next to a
  rounding boundary of the bf16 rounding or of the code can round the other
  way: codes within +-1, scales within rtol 1e-2 (as tests/test_act_quant.py
  holds the Pallas kernel against the plain chain);
- the LayerNorm prologues take their f32 statistics in other summation
  orders and 1/sqrt where the TPU kernel takes rsqrt: codes within +-1, and
  at most 1e-3 of them differ (the share is printed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import QuantConfig as JaxQuantConfig
from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan import causal_dit as jdit
from inferix_tpu.ops import act_quant as jaq
from inferix_tpu.ops import norms as jnorms
from inferix_tpu.quant import api as japi
from inferix_tpu.quant import kernels as jk
from inferix_tpu_torch.core.config import QuantConfig, tiny_test_config
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops import act_quant as taq
from inferix_tpu_torch.quant import api as tapi
from inferix_tpu_torch.quant import kernels as tk
from inferix_tpu_torch.utils.params import params_from_numpy

FLIP_SHARE = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


def _codes_close(got_q, got_s, want_q, want_s, scale_rtol, label):
    """Codes within +-1 with at most FLIP_SHARE of them differing; scales
    within scale_rtol. Prints the share of codes that differ."""
    gq, wq = _np(got_q).astype(np.int32), _np(want_q).astype(np.int32)
    assert gq.shape == wq.shape
    diff = np.abs(gq - wq)
    share = float((diff > 0).mean())
    print(f"{label}: {int((diff > 0).sum())} of {diff.size} codes differ "
          f"(share {share:.2e}, tol {FLIP_SHARE:g}), max |diff| {diff.max()}")
    assert diff.max() <= 1 and share <= FLIP_SHARE
    np.testing.assert_allclose(_np(got_s).reshape(-1), _np(want_s).reshape(-1),
                               rtol=scale_rtol, atol=0)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_weight_int8(per_channel, stacked):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 96, 80) if stacked else (96, 80)).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    qfn = lambda wi: jk.quantize_weight_int8(wi, per_channel)
    jq, js = jax.vmap(qfn)(jnp.asarray(w)) if stacked else qfn(jnp.asarray(w))
    tq, ts = tk.quantize_weight_int8(torch.from_numpy(w), per_channel)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_act_int8_per_token(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 160)).astype(np.float32) * 3
    x[0, 4] = 0.0
    jx, tx = _pair(x, dtype)
    jq, js = jk.quantize_act_int8_per_token(jx)
    tq, ts = tk.quantize_act_int8_per_token(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n,per_token,per_channel", [
    (100, 256, 384, True, True),     # ragged M against the Pallas blocks
    (1, 128, 256, True, True),
    (64, 512, 128, False, False),    # per-tensor scales
    (33, 96, 136, True, False),      # K, N off the 128 grid
])
def test_int8_matmul_reference_matches_jax(m, k, n, per_token, per_channel):
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    xs = (rng.random((m, 1) if per_token else (1, 1)) * 0.05 + 1e-3).astype(np.float32)
    ws = (rng.random(n if per_channel else 1) * 0.02 + 1e-4).astype(np.float32)
    want_pallas = jk.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                                 jnp.asarray(ws), out_dtype=jnp.float32,
                                 interpret=True)
    want_xla = jk.int8_matmul_xla(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
                                  jnp.asarray(ws), out_dtype=jnp.float32)
    got = tk.int8_matmul_reference(*map(torch.from_numpy, (xq, wq, xs, ws)),
                                   out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), rtol=1e-6, atol=1e-6)
    # the kernel's K-contiguous weight layout gives the same numbers
    wt = torch.from_numpy(wq).t().contiguous().t()
    got_t = tk.int8_matmul_reference(torch.from_numpy(xq), wt, torch.from_numpy(xs),
                                     torch.from_numpy(ws), out_dtype=torch.float32)
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantized_linear_matches_jax(dtype, per_channel):
    """quantize -> int8 product -> epilogue -> bias, against the JAX
    quantized_linear (XLA path): equal in float32, and in bf16 (the bias
    added after the cast in both)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 384)).astype(np.float32) * 0.05
    b = rng.standard_normal(384).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    jqc = JaxQuantConfig(granularity="per_channel" if per_channel else "per_tensor")
    qc = QuantConfig(granularity=jqc.granularity)
    (jw, tw), (jb, tb), (jx, tx) = (_pair(a, dtype) for a in (w, b, x))
    jp = japi._quantize_leaf_linear({"w": jw, "b": jb}, jqc)
    tp = tapi._quantize_leaf_linear({"w": tw, "b": tb}, qc)
    want = japi.quantized_linear(jp, jx)
    got = tapi.quantized_linear(tp, tx)
    assert got.dtype == dtype and got.shape == (2, 9, 384)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ffn", [256, 200])
def test_quantized_ffn_folds_gelu_at_any_width(ffn, monkeypatch):
    """quantized_ffn quantizes fc1's input and runs the gelu inside fc2's
    act-quant at every width (the JAX package's multiple-of-128 gate is the
    TPU's, not the CUDA kernels'). Where the JAX package takes its fused
    path too (width 256), the two agree within 1e-3 relative in float32 (the
    gelu's tanh is computed by other implementations, ulps apart); at width
    200 the port equals its own chain spelled out, exactly."""
    rng = np.random.default_rng(11)
    d = 128
    w1 = rng.standard_normal((d, ffn)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((ffn, d)).astype(np.float32) * 0.1
    b1, b2 = (rng.standard_normal(n).astype(np.float32) * 0.1 for n in (ffn, d))
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    qc, jqc = QuantConfig(enabled=True), JaxQuantConfig(enabled=True)
    tp1, tp2 = (tapi._quantize_leaf_linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, qc)
                for w, b in ((w1, b1), (w2, b2)))
    acts = []
    quant = tapi.quantize_rows_int8
    monkeypatch.setattr(tapi, "quantize_rows_int8",
                        lambda x2, act=None: acts.append(act) or quant(x2, act=act))
    got = tapi.quantized_ffn(tp1, tp2, torch.from_numpy(x))
    assert acts == [None, "gelu"] and got.shape == (2, 9, d)
    if ffn % 128 == 0:
        jp1, jp2 = (japi._quantize_leaf_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jqc)
                    for w, b in ((w1, b1), (w2, b2)))
        japi.set_fused_act_quant(True, interpret=True)
        try:
            want = np.asarray(japi.quantized_ffn(jp1, jp2, jnp.asarray(x)))
        finally:
            japi.set_fused_act_quant(False)
        err = float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))
        print(f"quantized_ffn vs JAX fused: rel err {err:.2e} (tol 1e-3)")
        assert err <= 1e-3
    else:
        h = tapi.quantized_linear(tp1, torch.from_numpy(x)).reshape(-1, ffn)
        hq, hs = taq.quantize_rows_int8_reference(h, "gelu")
        want = tk.int8_matmul_reference(hq, tp2["w_q"], hs, tp2["scale"],
                                        out_dtype=torch.float32, bias=tp2["b"])
        np.testing.assert_array_equal(_np(got).reshape(-1, d), _np(want))


@pytest.mark.parametrize("act", taq.ACTS)
def test_quantize_rows_int8_matches_pallas(act):
    """The plain version of the act-quant kernel against the Pallas kernel
    in interpret mode, bf16 in (the main path's type)."""
    rng = np.random.default_rng(4)
    k = 512 if act == "silu_mul" else 384
    x = rng.standard_normal((70, k)).astype(np.float32) * 2.0
    x[3] = 0.0
    jx, tx = _pair(x, torch.bfloat16)
    jq, js = jaq.quantize_rows_int8(jx, act=act, interpret=True)
    tq, ts = taq.quantize_rows_int8(tx, act=act)
    assert tq.shape == jq.shape and ts.shape == js.shape
    if act is None:
        # exact against the JAX package's XLA quantizer ...
        rq, rs = jk.quantize_act_int8_per_token(jx)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=0, atol=0)
        # ... and against the interpreted Pallas kernel, whose scale is
        # absmax * (1/127): equal codes on every row whose scale is equal
        same = (ts.numpy() == np.asarray(js))[:, 0]
        print(f"act None: {int((~same).sum())} of {len(same)} interpreted "
              "scales 1 ulp away")
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -23, atol=0)
        np.testing.assert_array_equal(tq.numpy()[same], np.asarray(jq)[same])
        assert np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    else:
        diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        print(f"act {act}: {int((diff > 0).sum())} of {diff.size} codes differ")
        assert diff.max() <= 1
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-2, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_quantize_rows_int8_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    b, f, fs, c = 2, 3, 16, 256
    x = rng.standard_normal((b, f * fs, c)).astype(np.float32) * 2 + 0.5
    shift = rng.standard_normal((b, f, c)).astype(np.float32)
    scale = rng.standard_normal((b, f, c)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jq, js = jaq.adaln_quantize_rows_int8(jx, jnp.asarray(shift), jnp.asarray(scale),
                                          eps=1e-6, interpret=True)
    # the modulation arrives as strided slices of [B, F, 6, C] on the path
    mod = torch.zeros(b, f, 6, c)
    mod[:, :, 0], mod[:, :, 1] = torch.from_numpy(shift), torch.from_numpy(scale)
    tq, ts = taq.adaln_quantize_rows_int8(tx, mod[:, :, 0], mod[:, :, 1], eps=1e-6)
    assert tq.shape == (b, f * fs, c) and ts.shape == (b, f * fs, 1)
    if dtype == torch.float32:
        _codes_close(tq, ts, jq, js, 1e-6, f"adaln {dtype}")
        return
    # bf16: exact against the JAX package's unfused chain ...
    h = jnorms.layer_norm(jx, eps=1e-6).reshape(b, f, fs, c)
    h = (h * (1.0 + jnp.asarray(scale)[:, :, None]).astype(h.dtype)
         + jnp.asarray(shift)[:, :, None].astype(h.dtype)).reshape(b, f * fs, c)
    rq, rs = jk.quantize_act_int8_per_token(h)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=0, atol=0)
    # ... and within a code and a bf16 ulp of the interpreted Pallas kernel
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    print(f"adaln bf16 vs interpreted Pallas: {int((diff > 0).sum())} of "
          f"{diff.size} codes differ (share {float((diff > 0).mean()):.2e})")
    assert diff.max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_quantize_rows_int8_matches_pallas(affine, dtype):
    rng = np.random.default_rng(6)
    m, c = 100, 384
    x = rng.standard_normal((m, c)).astype(np.float32) * 3 - 1
    w = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, bb))
    args_j = (jw, jb) if affine else (None, None)
    args_t = (tw, tb) if affine else (None, None)
    jq, js = jaq.ln_quantize_rows_int8(jx, *args_j, eps=1e-6, interpret=True)
    tq, ts = taq.ln_quantize_rows_int8(tx, *args_t, eps=1e-6)
    _codes_close(tq, ts, jq, js, 1e-2 if dtype == torch.bfloat16 else 1e-6,
                 f"ln affine={affine} {dtype}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
def test_quantize_params_and_fused_qkv(granularity):
    """quantize_params, then fuse_qkv_params, on the same float tree: the
    same keys, codes, scales and biases as the JAX package."""
    cfg = jax_tiny_config()
    jp = jdit.init_params(jax.random.key(0), cfg.model, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    jqc = JaxQuantConfig(enabled=True, granularity=granularity)
    tqc = QuantConfig(enabled=True, granularity=granularity)
    jq, tq = japi.quantize_params(jp, jqc), tapi.quantize_params(tp, tqc)
    for jt, tt in ((jq, tq), (jdit.fuse_qkv_params(jq), tdit.fuse_qkv_params(tq))):
        jf, tf = _flat(jt), _flat(tt)
        assert jf.keys() == tf.keys()
        n_q = 0
        for key in jf:
            want = np.asarray(jf[key])
            assert str(tf[key].dtype).split(".")[-1] == want.dtype.name, key
            assert tuple(tf[key].shape) == want.shape, key
            np.testing.assert_array_equal(tf[key].numpy(), want, err_msg=key)
            n_q += key.endswith("w_q")
        assert n_q == (10 if "blocks/self_attn/q/w_q" in jf else 8)
    assert "w" in tq["head"]["head"] and "w" in tq["text_embedding"]["fc1"]
    assert tapi.quantize_params(tp, QuantConfig(enabled=False)) is tp


def test_params_from_numpy_keeps_int8_and_float32_scales():
    """A bf16 model's quantized tree carried across: w_q stays int8, scale
    stays float32 (a bf16 scale would move every output), the rest bf16."""
    cfg = jax_tiny_config()
    jp = jdit.init_params(jax.random.key(1), cfg.model, dtype=jnp.bfloat16)
    jq = jdit.fuse_qkv_params(japi.quantize_params(jp, JaxQuantConfig(enabled=True)))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", torch.bfloat16)
    sa = tq["blocks"]["self_attn"]["qkv"]
    assert sa["w_q"].dtype == torch.int8 and sa["scale"].dtype == torch.float32
    assert sa["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sa["scale"].numpy(), np.asarray(jq["blocks"]["self_attn"]["qkv"]["scale"]))
    np.testing.assert_array_equal(
        tq["blocks"]["ffn"]["fc2"]["w_q"].numpy(),
        np.asarray(jq["blocks"]["ffn"]["fc2"]["w_q"]))


def test_to_kernel_layout():
    """Each int8 weight becomes one K-contiguous copy of the same values;
    float leaves are untouched."""
    rng = np.random.default_rng(7)
    w_q = torch.from_numpy(rng.integers(-127, 128, (2, 64, 48), dtype=np.int8))
    tree = {"lin": {"w_q": w_q, "scale": torch.ones(2, 48), "b": torch.zeros(2, 48)},
            "f": {"w": torch.ones(3, 4), "b": torch.zeros(4)}}
    out = tapi.to_kernel_layout(tree)
    got = out["lin"]["w_q"]
    assert torch.equal(got, w_q) and got.shape == w_q.shape
    assert got[1].stride() == (1, 64)
    assert out["f"]["w"] is tree["f"]["w"]
    assert tapi.to_kernel_layout(out)["lin"]["w_q"].data_ptr() == got.data_ptr()


def test_wrappers_on_cpu_take_the_plain_version():
    """On CPU tensors every wrapper returns its plain version's result and
    counts no launch."""
    counters = (tk.int8_matmul, taq.quantize_rows_int8,
                taq.adaln_quantize_rows_int8, taq.ln_quantize_rows_int8)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 32, 128)).astype(np.float32))
    sh = torch.from_numpy(rng.standard_normal((2, 2, 128)).astype(np.float32))
    xq, xs = taq.quantize_rows_int8(x[0])
    ref = taq.quantize_rows_int8_reference(x[0])
    assert torch.equal(xq, ref[0]) and torch.equal(xs, ref[1])
    got = taq.adaln_quantize_rows_int8(x, sh, -sh)
    ref = taq.adaln_quantize_rows_int8_reference(x, sh, -sh)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = taq.ln_quantize_rows_int8(x[0], sh[0, 0], sh[0, 1])
    ref = taq.ln_quantize_rows_int8_reference(x[0], sh[0, 0], sh[0, 1])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    wq = torch.from_numpy(rng.integers(-127, 128, (128, 64), dtype=np.int8))
    out = tk.int8_matmul(xq, wq, xs, torch.full((64,), 0.01))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tk.int8_matmul_reference(xq, wq, xs, torch.full((64,), 0.01)))
    assert [c.launches for c in counters] == before


def test_fp8_and_bad_arguments_raise():
    """The fp8 entry points return (e4m3 trees, the GEMM, the param bridge),
    the fp8 GEMM refuses operands it cannot take (on the CPU through its
    plain version; the card's operand checks are called directly), and the
    int8 paths refuse bad arguments."""
    tree = tapi.quantize_params({"blocks": {"ffn": {"fc1": {"w": torch.ones(2, 4, 4),
                                                            "b": torch.zeros(2, 4)}}}},
                                QuantConfig(enabled=True, dtype="fp8"))
    fc1 = tree["blocks"]["ffn"]["fc1"]
    assert fc1["w_q"].dtype == torch.float8_e4m3fn and fc1["scale"].shape == (2, 4)
    w8 = torch.ones(16, 8).to(torch.float8_e4m3fn)
    out = tk.fp8_matmul(torch.ones(2, 16), w8, torch.full((8,), 0.5))
    assert out.dtype == torch.bfloat16 and torch.equal(out, torch.full((2, 8), 8.0).bfloat16())
    carried = params_from_numpy({"w_q": np.asarray(jnp.ones((2, 2), jnp.float8_e4m3fn)),
                                 "scale": np.ones(2, np.float32)}, "cpu")
    assert carried["w_q"].dtype == torch.float8_e4m3fn and carried["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="quant dtype"):
        QuantConfig(enabled=True, dtype="int4")
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tk.fp8_matmul(torch.ones(2, 16), torch.ones(16, 8, dtype=torch.int8), torch.ones(8))
    with pytest.raises(ValueError, match="w_q"):
        tk.fp8_matmul(torch.ones(2, 32), w8, torch.ones(8))
    with pytest.raises(ValueError, match="w_scale"):
        tk.fp8_matmul(torch.ones(2, 16), w8, torch.ones(3))
    xb = torch.ones(2, 16, dtype=torch.bfloat16)
    wk = w8.t().contiguous().t()
    check = tk._check_fp8_cuda_operands
    check(xb, wk, torch.ones(8), None, torch.bfloat16)  # takes what the kernel takes
    for exc, match, args in (
            (TypeError, "bfloat16", (xb.float(), wk, torch.ones(8), None, torch.bfloat16)),
            (TypeError, "float8_e4m3fn", (xb, wk.float(), torch.ones(8), None, torch.bfloat16)),
            (ValueError, "K-contiguous", (xb, w8, torch.ones(8), None, torch.bfloat16)),
            (ValueError, "w_scale", (xb, wk, torch.ones(7), None, torch.bfloat16)),
            (ValueError, "w_scale", (xb, wk, torch.ones(9), None, torch.bfloat16)),
            (TypeError, "w_scale", (xb, wk, torch.ones(8).double(), None, torch.bfloat16)),
            (ValueError, "bias", (xb, wk, torch.ones(1), torch.ones(3), torch.bfloat16)),
            (TypeError, "out_dtype", (xb, wk, torch.ones(1), None, torch.float16)),
            (ValueError, "K % 16", (xb[:, :8], wk[:8], torch.ones(8), None, torch.bfloat16))):
        with pytest.raises(exc, match=match):
            check(*args)
    with pytest.raises(ValueError, match="unknown act"):
        taq.quantize_rows_int8(torch.ones(2, 128), act="relu")
    with pytest.raises(ValueError, match="x_scale"):
        tk.int8_matmul(torch.ones(4, 16, dtype=torch.int8),
                       torch.ones(16, 8, dtype=torch.int8), torch.ones(3, 1),
                       torch.ones(8))
    with pytest.raises(ValueError, match="weight and bias"):
        taq.ln_quantize_rows_int8(torch.ones(2, 128), torch.ones(128))


# The kernels' row classes at the widths the paths and the JAX package's
# configs quantize: Wan2.1 1.3B (the K/V head 128, dim 1536, ffn 8960 and
# silu_mul over 2 x 8960), MAGI (hidden 3072, ffn 12288 and silu_mul over
# 2 x 12288, `inferix_tpu/models/magi/dit.py:61-62`), 6144, and each class
# edge. A row of width w has w / 8 chunks; (G, chunks a thread).
@pytest.mark.parametrize("width,plan", [
    (128, (16, 1)), (1536, (32, 6)), (8960, (128, 9)), (3072, (128, 3)),
    (6144, (128, 6)), (12288, (128, 12)),
    (8, (16, 1)), (120, (16, 1)), (136, (32, 1)), (1544, (128, 2)),
    (2048, (128, 2)), (9216, (128, 9)), (9224, (128, 10)),
    (12296, (128, 13)),  # past the register classes: the row is read twice
])
def test_row_plan_classes(width, plan):
    assert taq.row_plan(width) == plan
    g, nc = plan
    chunks = width // 8
    assert (nc - 1) * g < chunks <= nc * g  # no idle chunk column
    resident = nc <= max(most for gg, most in taq.ROW_CLASSES if gg == g)
    assert resident == (width <= taq.MAX_LN_WIDTH) and taq.MAX_LN_WIDTH == 12288


@pytest.mark.parametrize("k,act,plan", [
    (2 * 8960, "silu_mul", (128, 9)), (2 * 12288, "silu_mul", (128, 12)),
    (8960, "gelu", (128, 9)), (8960, "gelu_exact", (128, 9)), (128, None, (16, 1)),
    # the row-parallel inputs at tp 2: Wan's o (768) and fc2 (4480), MAGI-4.5B's
    # proj (3072) and fc2 (6144), MAGI-24B's proj (6144) and split fc2 (8192)
    (768, None, (32, 3)), (4480, "gelu", (128, 5)), (3072, None, (128, 3)),
    (6144, "gelu_exact", (128, 6)), (6144, None, (128, 6)), (2 * 8192, "silu_mul", (128, 8))])
def test_row_plan_of_an_activation_takes_its_output_width(k, act, plan):
    """silu_mul reads [gate | up] and quantizes half the input width."""
    assert taq.row_plan(taq._out_width(k, act)) == plan


@pytest.mark.parametrize("width,act", [(0, None), (12, None), (1540, "gelu"),
                                      (24, "silu_mul"), (8968, "silu_mul"),
                                      (7, "silu_mul")])
def test_row_plan_refuses_widths_the_kernels_cannot_load(width, act):
    """A width that is not a multiple of 8 (16 for silu_mul's [gate | up]
    input) has no class: the 16-byte loads would straddle rows."""
    with pytest.raises(ValueError):
        taq.row_plan(taq._out_width(width, act))


@pytest.mark.parametrize("width", [12, 12296])
def test_cpu_tensors_take_the_plain_versions_at_any_width(width):
    """Widths no kernel class takes (12) or the LayerNorm kernel refuses
    (past 12288) still go through the plain versions on CPU tensors, with
    no launch counted."""
    counters = (taq.quantize_rows_int8, taq.adaln_quantize_rows_int8,
                taq.ln_quantize_rows_int8)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 6, width)).astype(np.float32))
    x = x.to(torch.bfloat16)
    mod = torch.from_numpy(rng.standard_normal((2, 3, 2, width)).astype(np.float32))
    for got, ref in (
            (taq.quantize_rows_int8(x[0]), taq.quantize_rows_int8_reference(x[0])),
            (taq.ln_quantize_rows_int8(x[0]), taq.ln_quantize_rows_int8_reference(x[0])),
            (taq.adaln_quantize_rows_int8(x, mod[:, :, 0], mod[:, :, 1]),
             taq.adaln_quantize_rows_int8_reference(x, mod[:, :, 0], mod[:, :, 1]))):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [c.launches for c in counters] == before


# ---------------------------------------------------------------------------
# MAGI's quantizers (`magi_distill_quant_to_int8`, `magi_quantize_params_int8`)
# ---------------------------------------------------------------------------

def _magi_fp8_tree(num_layers, fp8_layers):
    import dataclasses

    from inferix_tpu.models.magi.dit import tiny_magi_config
    from inferix_tpu.utils.checkpoint import convert_magi_state_dict
    from test_magi_torch_parity import make_reference_sd

    cfg = dataclasses.replace(tiny_magi_config(), num_layers=num_layers)
    return convert_magi_state_dict(make_reference_sd(cfg, fp8_layers), cfg, dtype=jnp.float32)


def _assert_int8_leaves_equal(got, want, path=""):
    """Every leaf equal (codes and float32 scales exactly); each int8 w_q
    laid out K-contiguous for the int8 GEMM."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_int8_leaves_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, path
    if path.endswith("w_q") and got.dtype == torch.int8:
        assert got.stride()[-2:] == (1, got.shape[-2]), (path, got.stride())
    if got.dtype == torch.float8_e4m3fn:  # passed through: values exact in float32
        got, want = got.float(), want.astype(np.float32)
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=path)


def test_magi_distill_quant_to_int8_matches_jax():
    """The fp8 distill layout (one e4m3 middle layer, stacked; per-tensor
    and per-channel linears) requantized to int8 on both sides: codes and
    scales equal, the other leaves passed through."""
    jt = _magi_fp8_tree(3, (1,))
    want = japi.magi_distill_quant_to_int8(jt)
    got = tapi.magi_distill_quant_to_int8(params_from_numpy(jax.tree.map(np.asarray, jt),
                                                            "cpu", torch.float32))
    _assert_int8_leaves_equal(got, want)
    mid = got["blocks_mid"]
    assert mid["proj"]["w_q"].dtype == torch.int8 and set(mid["proj"]) == {"w_q", "scale"}
    assert got["blocks_first"]["q"]["w"].dtype == torch.float32


def test_magi_distill_quant_to_int8_per_layer_row_scales():
    """Two stacked e4m3 middle layers: the port takes each layer's row
    scale input_scale[i] / smooth_scale[i] and equals the JAX requant of
    each layer alone. The JAX function refuses the stacked tree: its
    input_scale [L] / smooth_scale [L, K] broadcasts L against K."""
    jt = _magi_fp8_tree(4, (1, 2))
    with pytest.raises(ValueError, match="broadcast"):
        japi.magi_distill_quant_to_int8(jt)
    got = tapi.magi_distill_quant_to_int8(params_from_numpy(jax.tree.map(np.asarray, jt),
                                                            "cpu", torch.float32))
    for i in range(2):
        layer = jax.tree.map(lambda a: a[i], jt["blocks_mid"])
        want = japi.magi_distill_quant_to_int8(layer)
        _assert_int8_leaves_equal({k: {n: x[i] for n, x in v.items()}
                                   for k, v in got["blocks_mid"].items()}, want)


@pytest.mark.parametrize("layout", ["blocks", "fp8_first_last", "split_fc1"])
def test_magi_quantize_params_int8_matches_jax(layout):
    """Plain MAGI trees to W8A8 on both sides: the stacked `blocks`, the
    unstacked first / last layers of the fp8 layout, and a gated tree with
    fc1 split into fc1 / fc1_up; a linear's bias kept."""
    import dataclasses

    from inferix_tpu.models.magi import dit as jmagi
    from inferix_tpu_torch.models.magi import dit as tmagi

    if layout == "fp8_first_last":
        jt = _magi_fp8_tree(3, (1,))
    else:
        cfg = jmagi.tiny_magi_config()
        if layout == "split_fc1":
            cfg = dataclasses.replace(cfg, gated_linear_unit=True)
        jt = jmagi.init_magi_params(jax.random.key(2), cfg, jnp.float32)
        jt["blocks"]["q"]["b"] = jnp.ones_like(jt["blocks"]["q"]["w"][:, 0])
        if layout == "split_fc1":
            jt = jmagi.split_gated_fc1(jt, cfg.ffn_hidden_size)
    tt = params_from_numpy(jax.tree.map(np.asarray, jt), "cpu", torch.float32)
    if layout == "split_fc1":
        tt = tmagi.split_gated_fc1(tt, 256)
        tt["blocks"] = {k: ({n: x.contiguous() for n, x in v.items()} if isinstance(v, dict)
                            else v) for k, v in tt["blocks"].items()}
    want = japi.magi_quantize_params_int8(jt)
    got = tapi.magi_quantize_params_int8(tt)
    _assert_int8_leaves_equal(got, want)
    if layout == "blocks":
        assert "b" in got["blocks"]["q"] and got["blocks"]["fc2"]["w_q"].dtype == torch.int8
        assert got["final_linear"]["w"] is tt["final_linear"]["w"]

