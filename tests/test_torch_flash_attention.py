"""The plain version of the port's flash-attention kernel against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_flash_attention.py runs it.

Both take float32 inputs drawn with numpy from a seed. The port's plain
version repeats the CUDA kernel's arithmetic (exp2 domain, fixedm or runmax,
max(l, 1e-30), LSE / log2(e)); it differs from the Pallas kernel only in the
order of its float32 sums, hence 1e-5. The CUDA kernel itself is held
against this plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.kvcache.cache import quantize_kv_block as jax_quantize_kv_block
from inferix_tpu.ops.flash_attention import flash_attention_prefix as jax_flash
from inferix_tpu.ops.flash_attention import flash_attention_prefix_quant as jax_flash_quant
from inferix_tpu_torch import _build
from inferix_tpu_torch.ops import act_quant as taq
from inferix_tpu_torch.ops import flash_attention as tfa
from inferix_tpu_torch.ops import halo_conv as thc
from inferix_tpu_torch.quant import kernels as tk

TOL = dict(rtol=1e-5, atol=1e-5)
B2_START, B2_END = [0, 37], [500, 611]


def _inputs(b, seed=0, sq=24, skv=640, h=2, d=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d))]


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
@pytest.mark.parametrize("kv_start,kv_len", [(0, 640), (0, 300), (0, 1), (200, 517)])
def test_reference_matches_pallas_kernel(kv_start, kv_len, softmax):
    """Bounds: the whole cache, a prefix, one key, and an unaligned span
    starting past 0."""
    q, k, v = _inputs(1)
    want, want_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)), jnp.int32(kv_len), kv_start,
        return_lse=True, interpret=True, q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_reference(
        *map(torch.from_numpy, (q, k, v)), kv_len, kv_start, softmax=softmax,
        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
def test_reference_empty_span(softmax):
    """An empty span gives out 0 and the LSE of the 1e-30 floor (plus the
    -1e30 initial max under runmax). The Pallas kernel agrees on the LSE in
    both modes and on the output under fixedm; under runmax it averages the
    masked block uniformly instead (its masked logits equal its initial
    max, so exp2(s - m) = 1). No caller attends over an empty span: the
    cache always holds the block being denoised."""
    q, k, v = _inputs(1)
    want, want_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)), jnp.int32(130), 130,
        return_lse=True, interpret=True, q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_reference(
        *map(torch.from_numpy, (q, k, v)), 130, 130, softmax=softmax,
        return_lse=True)
    assert not got.any()
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    if softmax == "fixedm":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
def test_reference_per_row_bounds(softmax):
    """B=2 with a different span per batch row ([B] bounds)."""
    q, k, v = _inputs(2, seed=1)
    want, want_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(B2_END, jnp.int32),
        jnp.asarray(B2_START, jnp.int32), return_lse=True, interpret=True,
        q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_reference(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(B2_END),
        torch.tensor(B2_START), softmax=softmax, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def _assert_within_pv_ulp(got, want, q, kq, vq, ks, vs, starts, ends):
    """The int8-KV kernels round each p * v_scale to bf16 from float32
    logits whose last bits differ between the two versions (other summation
    orders), so a p may round the other way: an output may differ by up to
    one bf16 ulp (2^-8 relative) of each of its terms p_j v_j / l. The bound
    per element is 2^-8 sum_j (p_j / l) |v_j| + 1e-5, from a float64
    softmax over the dequantized keys of each row's span."""
    b, sq, h, d = q.shape
    bound = np.empty_like(got)
    for i in range(b):
        s0, e0 = starts[i], ends[i]
        for hh in range(h):
            kd = kq[i, s0:e0, hh].astype(np.float64) * ks[i, s0:e0, hh, None]
            vd = np.abs(vq[i, s0:e0, hh].astype(np.float64) * vs[i, s0:e0, hh, None])
            logits = q[i, :, hh].astype(np.float64) @ kd.T * d ** -0.5
            p = np.exp(logits - logits.max(-1, keepdims=True))
            bound[i, :, hh] = 2.0 ** -8 * (p / p.sum(-1, keepdims=True)) @ vd + 1e-5
    err = np.abs(got - np.asarray(want))
    assert (err <= bound).all(), (err.max(), (err / bound).max())


def _quant_inputs(b, seed):
    """q float32 and an int8 K/V cache with its scales, quantized by the
    JAX package's own cache quantizer."""
    q, k, v = _inputs(b, seed)
    kq, ks = (np.array(a) for a in jax_quantize_kv_block(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_kv_block(jnp.asarray(v)))
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
@pytest.mark.parametrize("kv_start,kv_len", [(0, 640), (0, 300), (200, 517)])
def test_quant_reference_matches_pallas_kernel(kv_start, kv_len, softmax):
    """The int8-KV plain version against `_flash_kernel_quant` in interpret
    mode: the whole cache, a prefix and a span starting past 0, scalar
    bounds. Both round p * v_scale to bf16 before PV: the output within one
    bf16 ulp of its p.v terms (see _assert_within_pv_ulp), the LSE 1e-5."""
    q, kq, vq, ks, vs = _quant_inputs(1, seed=3)
    want, want_lse = jax_flash_quant(
        *map(jnp.asarray, (q, kq, vq, ks, vs)), jnp.int32(kv_len), kv_start,
        return_lse=True, interpret=True, q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_quant_reference(
        *map(torch.from_numpy, (q, kq, vq, ks, vs)), kv_len, kv_start,
        softmax=softmax, return_lse=True)
    _assert_within_pv_ulp(got.numpy(), want, q, kq, vq, ks, vs, [kv_start], [kv_len])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
def test_quant_reference_per_row_bounds(softmax):
    """B=2 with a span per batch row ([B] bounds), int8 K/V."""
    q, kq, vq, ks, vs = _quant_inputs(2, seed=4)
    want, want_lse = jax_flash_quant(
        *map(jnp.asarray, (q, kq, vq, ks, vs)), jnp.asarray(B2_END, jnp.int32),
        jnp.asarray(B2_START, jnp.int32), return_lse=True, interpret=True,
        q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_quant_reference(
        *map(torch.from_numpy, (q, kq, vq, ks, vs)), torch.tensor(B2_END),
        torch.tensor(B2_START), softmax=softmax, return_lse=True)
    _assert_within_pv_ulp(got.numpy(), want, q, kq, vq, ks, vs, B2_START, B2_END)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("softmax", ["fixedm", "runmax"])
@pytest.mark.parametrize("kv_start,kv_len", [(0, 640), (200, 517)])
def test_reference_fp8_kv_matches_pallas_kernel(kv_start, kv_len, softmax):
    """The plain version over a scale-free e4m3 K/V cache against
    `_flash_kernel` in interpret mode, which casts e4m3 to q's dtype in the
    kernel (exact, as in the port)."""
    q, k, v = _inputs(1, seed=5)
    k8, v8 = (torch.from_numpy(a).clamp(-448, 448).to(tfa.FP8) for a in (k, v))
    jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.float8_e4m3fn) for t in (k8, v8))
    np.testing.assert_array_equal(np.asarray(jk).view(np.uint8), k8.view(torch.uint8).numpy())
    want, want_lse = jax_flash(
        jnp.asarray(q), jk, jv, jnp.int32(kv_len), kv_start, return_lse=True,
        interpret=True, q_block=16, kv_block=128, softmax=softmax)
    got, lse = tfa.flash_attention_prefix_reference(
        torch.from_numpy(q), k8, v8, kv_len, kv_start, softmax=softmax,
        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_quant_wrapper_on_cpu_takes_the_plain_version():
    """On CPU tensors the int8-KV wrapper and its mask wrapper are the plain
    version and count no launch."""
    q, kq, vq, ks, vs = (torch.from_numpy(np.array(a)) for a in _quant_inputs(1, seed=6))
    before = tfa.flash_attention_prefix_quant.launches
    want = tfa.flash_attention_prefix_quant_reference(q, kq, vq, ks, vs, 300)
    assert torch.equal(tfa.flash_attention_prefix_quant(q, kq, vq, ks, vs, 300), want)
    masked = tfa.flash_attention_quant(q, kq, vq, ks, vs, kv_mask=torch.arange(640) < 300)
    assert torch.equal(masked, want)
    assert tfa.flash_attention_prefix_quant.launches == before


def test_wrapper_on_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no launch;
    the mask wrapper reads the span end from the mask's population count."""
    q, k, v = map(torch.from_numpy, _inputs(1, seed=2))
    before = tfa.flash_attention_prefix.launches
    got = tfa.flash_attention_prefix(q, k, v, 300, softmax="runmax")
    assert torch.equal(got, tfa.flash_attention_prefix_reference(q, k, v, 300, softmax="runmax"))
    masked = tfa.flash_attention(q, k, v, kv_mask=torch.arange(640) < 300)
    assert torch.equal(masked, tfa.flash_attention_prefix_reference(q, k, v, 300))
    assert tfa.flash_attention_prefix.launches == before
    with pytest.raises(ValueError, match="softmax"):
        tfa.flash_attention_prefix(q, k, v, 300, softmax="exact")


def test_bounds_tensor_for_the_kernel():
    """The [B, 2] int32 (kv_start, kv_end) table the kernel reads: ints are
    broadcast over the batch, [B] tensors give a bound per row."""
    got = tfa._bounds_tensor(0, torch.tensor([3, 5]), 2, "cpu")
    assert got.dtype == torch.int32 and got.tolist() == [[0, 3], [0, 5]]
    got = tfa._bounds_tensor(torch.tensor(7), 9, 3, "cpu")
    assert got.tolist() == [[7, 9]] * 3
    with pytest.raises(ValueError, match="scalar or"):
        tfa._bounds_tensor(0, torch.tensor([1, 2, 3]), 2, "cpu")


# Each kernel entry point's loader: (library, loader), the two GEMMs sharing
# one source.
_LOADERS = {
    "flash_attention_sm90": ("flash_attention_sm90", lambda: tfa._lib_sm90()),
    "gemm_sm90-int8": ("gemm_sm90", lambda: tk._kernel()),
    "act_quant": ("act_quant", lambda: taq._lib()),
    "halo_conv": ("halo_conv", lambda: thc._library()),
    "gemm_sm90-fp8": ("gemm_sm90", lambda: tk._fp8_kernel()),
    "flash_attention_sm90-quant": ("flash_attention_sm90", lambda: tfa._lib_quant_sm90()),
}


@pytest.mark.parametrize("entry", list(_LOADERS))
def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path, entry):
    """With no nvcc in $CUDA_HOME/bin, the toolkit directory or PATH, the
    build of each kernel library stops with an error that says so, whether
    asked for by name or by the loader of a kernel entry point in it."""
    name, loader = _LOADERS[entry]
    assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_BIN_DIRS", (str(tmp_path / "cuda" / "bin"),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        loader()
    assert not (tmp_path / "build").exists()


def test_csrc_holds_one_source_per_library():
    """Every source under csrc/ is a library the smoke script builds, and
    the retired GEMM sources are gone: each library's build key hashes its
    one file, so no source may include another."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted({name for name, _ in _LOADERS.values()})
    assert not list(_build.CSRC.glob("*.cuh")) and not list(_build.CSRC.glob("*.h"))
    for p in _build.CSRC.glob("*.cu"):
        assert '#include "' not in p.read_text(), p.name


def _fake_nvcc(tmp_path, body):
    """An executable `nvcc` in tmp_path/bin that runs the shell `body`."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path


def test_build_starts_one_nvcc_per_source_together(monkeypatch, tmp_path):
    """`build` starts every missing library's nvcc before it waits for any
    (each fake nvcc waits until all three have started), keys each library
    by its source, and skips one that is built already."""
    log = tmp_path / "started"
    home = _fake_nvcc(tmp_path, f"""
out=""; while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done
echo x >> {log}
i=0; while [ $(wc -l < {log}) -lt 3 ] && [ $i -lt 100 ]; do sleep 0.05; i=$((i+1)); done
[ $(wc -l < {log}) -ge 3 ] || exit 3
echo built > "$out"
""")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ["flash_attention_sm90", "gemm_sm90", "act_quant"]
    _build.build(names)
    libs = sorted(p.name.split("-")[0] for p in (tmp_path / "build").glob("lib*.so"))
    assert libs == sorted(f"lib{n}" for n in names)
    log.unlink()
    _build.build(names)  # all present: no nvcc runs
    assert not log.exists()


def test_build_reports_a_failed_source(monkeypatch, tmp_path):
    home = _fake_nvcc(tmp_path, "echo 'error: bad ptx' ; exit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build gemm_sm90.cu:\n.*bad ptx"):
        _build.build(["gemm_sm90"])
    assert not list((tmp_path / "build").glob("*.so"))


def _cache(layers=2, b=2, s=96, h=3, dtype=torch.int8):
    """A K cache [L, B, S, H, 128] as `init_kv_cache` lays it out."""
    return torch.zeros(layers, b, s, h, 128, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, tfa.FP8])
@pytest.mark.parametrize("view", ["layer", "batch_row", "token_window"])
def test_check_tma_kv_takes_cache_layer_slices(view, dtype):
    """The kernel's tensor-map rule admits what the paths pass it, for each
    K/V kind: a cache layer slice, one batch row of it, and a window of its
    tokens (its base moves by whole token rows of 384 or 768 bytes)."""
    layer = _cache(dtype=dtype)[1]
    t = {"layer": layer, "batch_row": layer[1:], "token_window": layer[:, 10:50]}[view]
    tfa.check_tma_kv("k", t)


@pytest.mark.parametrize("units,sms,want", [
    (444, 132, (396, 2)),   # 4680 q rows x 12 heads: 48 units in 2 pieces
    (888, 132, (888, 1)),   # B=2: the tail of 96 units cannot split in 2
    (396, 132, (396, 1)),   # whole rounds only
    (12, 132, (0, 4)),      # one partial round: every unit in 4 pieces
    (200, 132, (200, 1)),   # a tail of 68 units
])
def test_tail_split(units, sms, want):
    """The units of a partial last round split along the span into as many
    pieces as the idle SMs hold, at most 4; whole rounds are left whole."""
    assert tfa.tail_split(units, sms) == want


def _odd_token_stride(dtype=torch.int8, pad=8):
    """Token stride 3 * 128 + pad elements (392 bytes in int8, 776 in bf16 with
    pad 4): off the 16-byte grid."""
    return torch.zeros(1, 64, 3 * 128 + pad, dtype=dtype)[..., :3 * 128].view(1, 64, 3, 128)


def _misaligned(dtype=torch.int8):
    """A base 8 bytes off the 16-byte grid."""
    flat = torch.zeros(64 * 3 * 128 + 64, dtype=dtype)
    off = 8 // flat.element_size()
    return flat[off:off + 64 * 3 * 128].view(1, 64, 3, 128)


@pytest.mark.parametrize("make,match", [
    (_odd_token_stride, "multiples of 16 bytes"),
    (_misaligned, "16-byte aligned base"),
    (lambda: _cache()[0, :, :1].expand(2, 96, 3, 128), "positive"),  # stride 0
    (lambda: torch.zeros(1, 64, 128, 3, dtype=torch.int8).transpose(2, 3), "contiguous head"),
    (lambda: _cache()[0, :, :0], "Skv > 0"),       # an empty cache
    (lambda: torch.zeros(1, 64, 3, 64, dtype=torch.int8), "128"),
    # the bf16 and e4m3 kinds load through the same 4-D tensor maps
    (lambda: _odd_token_stride(torch.bfloat16, 4), "multiples of 16 bytes"),
    (lambda: _misaligned(torch.bfloat16), "16-byte aligned base"),
    (lambda: _cache(dtype=torch.bfloat16)[0, :, :1].expand(2, 96, 3, 128), "positive"),
    (lambda: _cache(dtype=torch.bfloat16)[0, :, :0], "Skv > 0"),
    (lambda: _cache(dtype=tfa.FP8)[0, :, :1].expand(2, 96, 3, 128), "positive"),
    (lambda: _cache(dtype=tfa.FP8)[0, :, :0], "Skv > 0"),
])
def test_check_tma_kv_refuses(make, match):
    """What the kernel's 4-D tensor maps cannot describe raises ValueError,
    for each K/V kind: a token stride or a base off the 16-byte grid (a bf16
    token stride that is not a multiple of 8 elements), a broadcast (zero)
    stride, a strided head dim, no token at all, another head dim."""
    with pytest.raises(ValueError, match=match):
        tfa.check_tma_kv("k", make())
