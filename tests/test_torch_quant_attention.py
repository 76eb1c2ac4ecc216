"""The plain versions of the port's int8-PV attention kernels (TPU kernels 3
and 4: `flash_attention_prefix_quant_i8` and `..._v2`) against the JAX
package's Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attention.py runs them: kv_block 128 over 3 groups of a
384-key int8 cache (quantized by the JAX package's own cache quantizer), a
partial boundary group (kv_len 300), [B] lengths, return_lse, kv_len 0 and
the default group.

Tolerance. Both sides compute the same codes round(u) from float32 values u
whose last bits may differ (the JAX dot sums q . k in float32, the port
exactly in float64 before one rounding; exp2 by other implementations), so
a code whose u lies within TIE = 1e-3 of a rounding tie may round the other
way and move its output by |v_q| * deq (carried to the output by the later
groups' exp2(m_g - m) and the final 1 / l). Per element:
    |out_port - out_jax| <= sum over such codes of |v_q| deq 2^(m_g - m) / l
                            + 1e-5 (|out_jax| + rms(out_jax))
(the second term: float32 sums in other orders). A code whose u is further
from a tie cannot round the other way; a wrong group rule, scale or order
moves most codes and fails the bound by orders of magnitude. The LSE within
1e-5 (relative, for kv_len 0's -6.9e29). Measured (this file's printouts,
CPU): max |diff| 1.8e-7 (i8) and 5.4e-7 (v2), at most 0.141 of the bound,
with 31-50 codes of each case within TIE of a tie (none of them flipped).
The CUDA kernels are held to these plain versions on the card by
chip_smoke.py, code by code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.kvcache.cache import quantize_kv_block as jax_quantize_kv_block
from inferix_tpu.ops.flash_attention import flash_attention_prefix_quant_i8 as jax_i8
from inferix_tpu.ops.flash_attention import flash_attention_prefix_quant_v2 as jax_v2
from inferix_tpu_torch.ops import flash_attention as tfa

TIE = 1e-3
SKV = 384
JAX = {"i8": jax_i8, "v2": jax_v2}
PORT = {"i8": tfa.flash_attention_prefix_quant_i8,
        "v2": tfa.flash_attention_prefix_quant_v2}


def _inputs(b, seed, sq=24, h=2, d=128, vary_v_scale=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, SKV, h, d)).astype(np.float32) for _ in range(2))
    kq, ks = (np.array(a) for a in jax_quantize_kv_block(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_kv_block(jnp.asarray(v)))
    if vary_v_scale:  # scales that vary by key, so the group's max V scale matters
        vs = vs * np.linspace(0.5, 2.0, SKV, dtype=np.float32)[None, :, None]
    return q, kq, vq, ks, vs


def _tie_bound(mode, tq, kv_len, kv_block):
    """(plain out, lse, per-element bound on its distance from another
    computation of the same codes whose u differ in their last bits,
    number of codes near a tie)."""
    masses = {}

    def on_group(i, g0, g1, u, m, deq):
        near = ((u - torch.floor(u) - 0.5).abs() < TIE).double()
        v = tq[2][i, g0:g1].permute(1, 0, 2).double().abs()
        masses.setdefault(i, []).append((torch.matmul(near, v) * deq.double(), m.double(),
                                         int(near.sum())))

    out, lse = tfa.quant_ext_reference(mode, *tq, kv_len, None, kv_block, True,
                                        on_group=on_group)
    b, sq, h, d = out.shape
    bound = torch.zeros(b, sq, h, d, dtype=torch.float64)
    n_near = 0
    for i, groups in masses.items():
        m_fin = groups[-1][1]
        denom = torch.exp2(lse[i].double()[..., None] * tfa.LOG2E - m_fin)  # [H, Sq, 1]
        for mass, m_g, n in groups:
            bound[i] += (mass * torch.exp2(m_g - m_fin) / denom).permute(1, 0, 2)
            n_near += n
    return out, lse, bound, n_near


@pytest.mark.parametrize("mode", ["i8", "v2"])
@pytest.mark.parametrize("b,kv_len,kv_block", [
    (1, 300, 128),                 # 3 groups, the last partial
    (1, 384, 128),                 # the whole cache
    (2, [300, 17], 128),           # a length per batch row; one group only
    (1, 0, 128),                   # no key: out 0, the LSE of the floors
    (1, 300, None),                # the default group: one of 384 keys
])
def test_reference_matches_pallas_kernel(mode, b, kv_len, kv_block):
    q, kq, vq, ks, vs = _inputs(b, seed=b + (kv_block or 0) + 7 * (mode == "v2"))
    jlen = jnp.asarray(kv_len, jnp.int32)
    want, want_lse = JAX[mode](*map(jnp.asarray, (q, kq, vq, ks, vs)), jlen,
                               interpret=True, kv_block=kv_block, return_lse=True,
                               **({"q_block": 16} if mode == "v2" else {}))
    want, want_lse = np.asarray(want), np.asarray(want_lse)
    tq = tuple(map(torch.from_numpy, (q, kq, vq, ks, vs)))
    got, lse = PORT[mode](*tq, torch.as_tensor(kv_len), kv_block=kv_block,
                          return_lse=True)
    out, plain_lse, bound, n_near = _tie_bound(mode, tq, torch.as_tensor(kv_len), kv_block)
    assert torch.equal(got, out) and torch.equal(lse, plain_lse)  # the wrapper on CPU
    rms = np.sqrt((want.astype(np.float64) ** 2).mean()) if want.any() else 0.0
    tol = bound.numpy() + 1e-5 * (np.abs(want) + rms)
    err = np.abs(got.numpy().astype(np.float64) - want)
    print(f"{mode} b {b} kv_len {kv_len} kv_block {kv_block}: max |diff| {err.max():.2e}, "
          f"{n_near} codes within {TIE:g} of a tie, max |diff| / bound "
          f"{(err / np.maximum(tol, 1e-30)).max():.3f}")
    assert (err <= tol).all()
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    if kv_len == 0:
        assert not got.any()


@pytest.mark.parametrize("mode", ["i8", "v2"])
def test_against_dequantized_attention(mode):
    """Sanity, as the JAX package's own tests hold its kernels: the int8
    codes of q (i8) and p stay close to float attention over the
    dequantized cache (the JAX tests' tolerances: 6e-2 for i8, 2e-2 for
    v2), on the cache as its own quantizer leaves it."""
    q, kq, vq, ks, vs = _inputs(1, seed=11, vary_v_scale=False)
    kd = torch.from_numpy(kq.astype(np.float32) * ks[..., None])
    vd = torch.from_numpy(vq.astype(np.float32) * vs[..., None])
    want = tfa.flash_attention_prefix_reference(torch.from_numpy(q), kd, vd, 300,
                                                softmax="runmax")
    got = PORT[mode](*map(torch.from_numpy, (q, kq, vq, ks, vs)), 300, kv_block=128)
    tol = 6e-2 if mode == "i8" else 2e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_group_rule():
    """kv_block follows the JAX clipping: min(kv_block or 2048, max(128,
    ceil(Skv / 128) * 128)); a smaller group changes the result (p is
    quantized against each group's own max), a group past the cache
    does not."""
    assert tfa._kv_group(None, 32760) == 2048
    assert tfa._kv_group(None, 384) == 384
    assert tfa._kv_group(4096, 100) == 128
    assert tfa._kv_group(128, 32760) == 128
    with pytest.raises(ValueError, match="kv_block"):
        tfa._kv_group(0, 384)
    tq = tuple(map(torch.from_numpy, _inputs(1, seed=12)))
    for mode in ("i8", "v2"):
        whole = PORT[mode](*tq, 384, kv_block=384)
        assert torch.equal(whole, PORT[mode](*tq, 384, kv_block=4096))
        assert not torch.equal(whole, PORT[mode](*tq, 384, kv_block=128))


def test_wrappers_on_cpu_take_the_plain_version():
    """On CPU tensors both wrappers are their plain versions, count no
    launch and refuse operands split across devices."""
    tq = tuple(map(torch.from_numpy, _inputs(1, seed=13)))
    before = [PORT[m].launches for m in PORT]
    assert torch.equal(tfa.flash_attention_prefix_quant_i8(*tq, 200),
                       tfa.flash_attention_prefix_quant_i8_reference(*tq, 200))
    assert torch.equal(tfa.flash_attention_prefix_quant_v2(*tq, 200),
                       tfa.flash_attention_prefix_quant_v2_reference(*tq, 200))
    assert [PORT[m].launches for m in PORT] == before
    with pytest.raises(ValueError, match="mode"):
        tfa.quant_ext_reference("i4", *tq, 200, None, None, False)


def test_quantize_q_int8_matches_jax_wrapper():
    """The int8-QK wrapper's q quantization: codes equal to round(q * (127 /
    absmax)) with true divisions, and the row scale (absmax / 127) *
    (scale * log2(e)), as the JAX wrapper computes them."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    q[0, 1, 2] = 0.0  # an all-zero row takes the 1e-8 floor
    scale = 128 ** -0.5
    qf = jnp.asarray(q)
    absmax = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-8)
    want_q = jnp.clip(jnp.round(qf * (127.0 / absmax)), -127, 127).astype(jnp.int8)
    want_s = ((absmax / 127.0) * (scale * tfa.LOG2E))[..., 0]
    got_q, got_s = tfa.quantize_q_int8(torch.from_numpy(q), scale)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# The CUDA kernels' operand layouts (`csrc/flash_attention_sm90.cu`): what the
# wrapper lays out before the launch, and the numeric claim of the i8 fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skv", [32, 100, 128, 384])
def test_pv_operand_is_v_transposed_in_code_order(skv):
    """V^T [B, H, D, n32] with each 32-key chunk in the order of a thread's
    codes in the QK accumulator, against a direct index computation: key'
    = 16 h + 4 t + c holds key 16 h + 8 (c >> 1) + 2 t + (c & 1); zero past
    Skv (n32 = Skv rounded up to 32)."""
    rng = np.random.default_rng(skv)
    v = torch.from_numpy(rng.integers(-127, 128, (2, skv, 3, 128)).astype(np.int8))
    vt = tfa.pv_operand(v)
    n32 = -(-skv // 32) * 32
    assert vt.shape == (2, 3, 128, n32) and vt.is_contiguous()
    want = torch.zeros(2, 3, 128, n32, dtype=torch.int8)
    for kp in range(n32):
        chunk, r = divmod(kp, 32)
        half, r = divmod(r, 16)
        t, c = divmod(r, 4)
        key = 32 * chunk + 16 * half + 8 * (c >> 1) + 2 * t + (c & 1)
        if key < skv:
            want[:, :, :, kp] = v[:, key]
    assert torch.equal(vt, want)


@pytest.mark.parametrize("widen_k", [False, True])
def test_quant_operands_on_cpu_are_the_plain_layouts(widen_k):
    """On CPU tensors the pre-pass is its plain versions: V^T as
    `pv_operand` lays it out, and ("v2") the int8 keys widened to bf16,
    exactly; a strided cache view goes in as it is."""
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.integers(-127, 128, (2, 2, 200, 3, 128)).astype(np.int8))
    k, v = cache[0, :, :150], cache[1, :, :150]  # token stride H*D, batch stride 200*H*D
    vt, kb = tfa.quant_operands(k, v, widen_k)
    assert torch.equal(vt, tfa.pv_operand(v))
    if widen_k:
        assert kb.dtype == torch.bfloat16 and kb.is_contiguous()
        assert torch.equal(kb.float(), k.float())
    else:
        assert kb is None


@pytest.mark.parametrize("mode,skv,grp", [("i8", 384, 128), ("v2", 384, 128),
                                          ("v2", 300, 192)])
def test_quant_ext_rows_are_the_plain_versions_operations(mode, skv, grp):
    """The per-key rows [B, H, R, n32] and (v2) deq [B, H, groups]: i8 the
    k scale, v scale and log2 v scale; v2 the k scale and v_scale * (127 /
    vsb) with vsb = max(the group's largest v scale over every key of the
    group in the cache, 1e-20) and deq = vsb / 127, each the float32
    operation the plain version performs; zero past Skv."""
    rng = np.random.default_rng(skv + grp)
    ks = torch.from_numpy(rng.random((2, skv, 3), dtype=np.float32))
    vs = torch.from_numpy(rng.random((2, skv, 3), dtype=np.float32))
    vs[1, :grp, 2] = 0.0  # a group whose scales are all zero takes the 1e-20 floor
    rows, deq = tfa.quant_ext_rows(mode, ks, vs, grp)
    n32 = -(-skv // 32) * 32
    assert rows.shape == (2, 3, 3 if mode == "i8" else 2, n32)
    assert torch.equal(rows[..., skv:], torch.zeros_like(rows[..., skv:]))
    assert torch.equal(rows[:, :, 0, :skv], ks.permute(0, 2, 1))
    if mode == "i8":
        assert deq is None
        assert torch.equal(rows[:, :, 1, :skv], vs.permute(0, 2, 1))
        assert torch.equal(rows[:, :, 2, :skv], torch.log2(vs).permute(0, 2, 1))
        return
    assert deq.shape == (2, 3, -(-skv // grp))
    for gi, g0 in enumerate(range(0, skv, grp)):
        vsb = torch.clamp_min(vs[:, g0:g0 + grp].amax(1), 1e-20)            # [B, H]
        assert torch.equal(deq[:, :, gi], tfa._true_div(vsb, 127.0))
        ratio = vs[:, g0:g0 + grp] * tfa._true_div(127.0, vsb)[:, None, :]
        assert torch.equal(rows[:, :, 1, g0:min(g0 + grp, skv)], ratio.permute(0, 2, 1))


@pytest.mark.parametrize("case", ["cache slice", "token stride 0", "token stride 1544 bytes",
                                  "empty cache"])
def test_check_tma_kv_over_the_int8_pv_operands(case):
    """The int8-PV wrappers take K/V through `check_tma_kv` on the card, as
    B1 and B2 do: a cache layer slice passes; a broadcast (zero) stride, a
    token stride off the 16-byte grid and an empty cache raise."""
    cache = torch.zeros(2, 2, 64, 3, 128, dtype=torch.int8)
    if case == "cache slice":
        tfa.check_tma_kv("k", cache[0])
        tfa.check_tma_kv("v", cache[1, :, :40])
        return
    if case == "token stride 0":
        t = cache[0, :, :1].expand(2, 64, 3, 128)
    elif case == "empty cache":
        t = cache[0, :, :0]
    else:
        t = torch.zeros(2, 64, 3 * 128 + 8, dtype=torch.int8)[..., :3 * 128].view(2, 64, 3, 128)
    with pytest.raises(ValueError):
        tfa.check_tma_kv("k", t)


def test_fold_estimate_moves_codes_only_at_ties():
    """The i8 kernel's fold on the plain version's own values: the group's
    max logit taken as max(f32(q_i8 . k_i8) * k_scale) * q_scale lies within
    2 ulps of max(s); the codes' scale rmax estimated as exp2(max(s + lg2
    vs) - m) lies within 1e-5 of max(p * vs); codes formed against the
    estimate differ from the plain version's only where u lies within 1e-3
    of a rounding tie (the dequantization step stays the exact one)."""
    tq = tuple(map(torch.from_numpy, _inputs(1, seed=21, sq=64)))
    q, kq, vq, ks, vs = tq
    q_i8, qs = tfa.quantize_q_int8(q, 128 ** -0.5)
    seen = []

    def on_group(i, g0, g1, u, m, deq):
        x = torch.einsum("qhd,khd->hqk", q_i8[i].double(), kq[i, g0:g1].double()).float()
        ksg, vsg = ks[i, g0:g1].T[:, None, :], vs[i, g0:g1].T[:, None, :]
        qsr = qs[i].T[:, :, None]
        s = x * qsr * ksg                                      # the plain order
        m_hat = (x * ksg).amax(-1, keepdim=True) * qsr
        assert ((m_hat - s.amax(-1, keepdim=True)).abs()
                <= 2 * torch.finfo(torch.float32).eps * s.abs().amax(-1, keepdim=True)).all()
        pv = torch.exp2(s - m) * vsg
        rmax = torch.clamp_min(pv.amax(-1, keepdim=True), 1e-20)
        rhat = torch.clamp_min(torch.exp2((s + torch.log2(vsg)).amax(-1, keepdim=True) - m),
                               1e-20)
        assert ((rhat - rmax).abs() <= 1e-5 * rmax).all()
        flips = torch.round(pv * tfa._true_div(127.0, rhat)) != torch.round(u)
        assert ((u - torch.floor(u) - 0.5).abs()[flips] < TIE).all()
        seen.append(u.numel())

    tfa.quant_ext_reference("i8", *tq, 300, None, 128, False, on_group=on_group)
    assert sum(seen) == 2 * 64 * 300
