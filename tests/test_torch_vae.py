"""The port's halo conv plain versions and Wan causal-VAE decode against the
JAX package (`inferix_tpu/ops/halo_conv.py`, `inferix_tpu/models/wan/vae.py`),
float32 on the CPU, inputs drawn with numpy from a seed.

The Pallas halo kernels run in interpret mode, as tests/test_halo_conv.py
runs them. The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.wan import vae as jvae
from inferix_tpu.ops.halo_conv import halo_conv3d as jax_halo
from inferix_tpu.ops.halo_conv import halo_conv3d_w8a8 as jax_halo_w8a8
from inferix_tpu_torch.models.wan import vae as tvae
from inferix_tpu_torch.ops import halo_conv as thc
from inferix_tpu_torch.utils.params import init_vae_params, params_from_numpy

# the tiny decoder of tests/test_halo_conv.py: one upsample3d, 16x24 pixels
# after it (H*W >= 256: the halo gate takes the convs there)
TINY = dict(dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
            temperal_downsample=(True,))
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
# W8A8 decode: the float32 activations entering each W8A8 conv differ
# between the two packages in their last bits (convs and norms sum in other
# orders), so an activation code at a rounding boundary may round the other
# way, moving s_x * w into up to 27 * Cout outputs; measured 2.1% of the
# pixels off by more than 1e-4, at most 3.6e-3 of the video's scale, 5.8e-4
# in norm. Given the same input the two W8A8 convs agree to 1e-6
# (test_halo_conv_w8a8_reference_matches_pallas).
W8A8_DECODE_RTOL = 2e-3   # ||port - jax|| / ||jax||
W8A8_DECODE_MAX = 1e-2    # max |port - jax| / max |jax|


def _conv_inputs(tin, h, w, cin, cout, kt, seed=7):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((tin, h, w, cin)) * 0.1).astype(np.float32),
            (rng.standard_normal((kt, 3, 3, cin, cout)) * 0.05).astype(np.float32),
            rng.standard_normal((cout,)).astype(np.float32))


@pytest.mark.parametrize("tin,h,w,cin,cout,kt", [
    (4, 13, 17, 192, 192, 3),   # H % block != 0, W not 16-aligned
    (5, 10, 12, 96, 3, 3),      # RGB head (tiny cout)
    (3, 12, 20, 96, 48, 1),     # upsample half-channel conv
    (3, 9, 11, 16, 32, 3),      # Cin 16 (the decoder's first conv)
])
def test_halo_conv_reference_matches_pallas(tin, h, w, cin, cout, kt):
    """The bf16 kernel's plain version (27 tap-shifted f32 products) against
    the Pallas kernel in interpret mode, float32: the two sum up to 27*192
    products in other orders; atol 3e-5, rtol 1e-5 (the JAX package's own
    tolerance for this kernel against lax.conv)."""
    x, wt, b = _conv_inputs(tin, h, w, cin, cout, kt)
    want = jax_halo(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), interpret=True)
    got = thc.halo_conv3d(*map(torch.from_numpy, (x, wt, b)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("tin,h,w,cin,cout,kt", [
    (4, 12, 20, 96, 96, 3),     # single cout block
    (3, 7, 40, 128, 256, 3),    # cout blocking (n_co > 1)
    (4, 12, 20, 192, 96, 1),    # kt=1: the upsample conv class (w8a8-only)
])
def test_halo_conv_w8a8_reference_matches_pallas(tin, h, w, cin, cout, kt):
    """The W8A8 kernel's plain version against the int8 Pallas kernel in
    interpret mode: the same codes (the quantization is the JAX wrapper's,
    divisions included), exact integer sums and the same f32 epilogue, so
    the outputs agree to 1e-6; and within the JAX test's W8A8 bound (0.05 of
    the output scale) of the float32 conv."""
    x, wt, b = _conv_inputs(tin, h, w, cin, cout, kt, seed=11)
    b = b * 0.1
    want = jax_halo_w8a8(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), interpret=True)
    tx, tw, tb = map(torch.from_numpy, (x, wt, b))
    got = thc.halo_conv3d_w8a8(tx, tw, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    ref = thc.halo_conv3d_reference(tx, tw, tb).numpy()
    assert np.abs(got.numpy() - ref).max() <= 0.05 * np.abs(ref).max()


def test_conv_wrappers_count_no_launch_on_the_cpu():
    x, wt, b = map(torch.from_numpy, _conv_inputs(4, 8, 8, 16, 16, 3))
    counters = (thc.halo_conv3d, thc.halo_conv3d_w8a8, thc.quantize_conv_act)
    before = [f.launches for f in counters]
    assert torch.equal(thc.halo_conv3d(x, wt, b), thc.halo_conv3d_reference(x, wt, b))
    assert torch.equal(thc.halo_conv3d_w8a8(x, wt, b),
                       thc.halo_conv3d_w8a8_reference(x, wt, b))
    q, s_x = thc.quantize_conv_act(x)
    q_ref, s_ref = thc._quantize_conv_act(x)
    assert torch.equal(q, q_ref) and torch.equal(s_x, s_ref)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="3x3"):
        thc.halo_conv3d(x, wt[:, :1], b)
    with pytest.raises(ValueError, match="too few"):
        thc.halo_conv3d(x[:2], wt, b)


@pytest.mark.parametrize("w8a8", [False, True])
def test_pack_weight_lays_out_each_output_channel_contiguously(w8a8):
    """pack_weight: wk[dt, 3 dh + dw, n, c] = w[dt, dh, dw, c, n] (bf16, or
    the W8A8 weight codes with their s_w, exactly as quantize_conv_w8a8
    draws them), contiguous: per tap, each output channel's Cin values
    are one row of the kernel's TMA box (no padding: TMA zero-fills past
    Cin); a wrapper given it returns what it returns without, and refuses an
    operand built for another weight or precision."""
    x, wt, b = map(torch.from_numpy, _conv_inputs(4, 8, 8, 48, 24, 3))
    packed = thc.pack_weight(wt, w8a8=w8a8)
    if w8a8:
        _, w_el, sv = thc.quantize_conv_w8a8(x, wt)
        s_x = torch.clamp_min(x.abs().amax(), 1e-8) / torch.tensor(127.0)
        assert torch.equal(s_x * packed.s_w, sv)
    else:
        w_el = wt.to(torch.bfloat16)
        assert packed.s_w is None
    assert packed.wk.shape == (3, 9, 24, 48) and packed.wk.dtype == w_el.dtype
    assert packed.wk.is_contiguous()
    for dt, dh, dw in ((0, 0, 0), (1, 2, 1), (2, 1, 2)):
        assert torch.equal(packed.wk[dt, 3 * dh + dw], w_el[dt, dh, dw].T)
    kern = thc.halo_conv3d_w8a8 if w8a8 else thc.halo_conv3d
    assert torch.equal(kern(x, wt, b, packed=packed), kern(x, wt, b))
    with pytest.raises(ValueError, match="does not belong"):
        kern(x[..., :16], wt[:, :, :, :16], b, packed=packed)
    with pytest.raises(ValueError, match="does not belong"):
        kern(x, wt, b, packed=thc.pack_weight(wt, w8a8=not w8a8))


def _jax_act_quant(x):
    """The JAX W8A8 wrapper's activation quantization
    (`inferix_tpu/ops/halo_conv.py:183-185`), as it stands there."""
    xf = jnp.asarray(x).astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)), np.asarray(s_x)


def _tie_input(scale):
    """Values on every half-code tie k + 0.5 (k = -127..126) and on the codes
    themselves, times `scale` (a power of two: bf16 holds them all), with
    the absmax 127 * scale: v / s_x lands exactly on the ties, which round
    half to even."""
    k = np.arange(-127, 127, dtype=np.float32)
    v = np.concatenate([k + 0.5, k, [127.0, -127.0]]).astype(np.float32) * scale
    return np.random.default_rng(3).permutation(v).reshape(2, 3, 85, 1).repeat(16, axis=3)


@pytest.mark.parametrize("case", ["ties_scale_1", "ties_scale_2^-5", "ties_scale_2^6",
                                  "all_zero", "random"])
def test_act_quant_plain_matches_jax_bit_for_bit(case):
    """The activation quantization kernel's plain version (`_quantize_conv_act`,
    which `chip_smoke.py` holds the CUDA kernel to bit for bit) against the
    JAX wrapper's XLA chain: equal codes and an equal s_x, on values exactly
    at half-code ties (s_x = 1, 2^-5 and 2^6, where v / s_x is exact), on an
    all-zero tensor (the 1e-8 floor: s_x = 1e-8 / 127, codes 0) and on
    random bf16 values."""
    if case.startswith("ties"):
        scale = {"ties_scale_1": 1.0, "ties_scale_2^-5": 2.0 ** -5, "ties_scale_2^6": 64.0}[case]
        x = _tie_input(scale)
    elif case == "all_zero":
        x = np.zeros((2, 4, 8, 16), np.float32)
    else:
        x = np.random.default_rng(5).standard_normal((3, 6, 10, 32)).astype(np.float32)
    # bf16 values, as the kernel sees them
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    q, s_x = thc._quantize_conv_act(torch.from_numpy(x))
    q_jax, s_jax = _jax_act_quant(x)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s_x.numpy().view(np.uint32) == s_jax.view(np.uint32)
    np.testing.assert_array_equal(q.numpy(), q_jax)
    if case.startswith("ties"):
        # half to even: +-0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        k = np.round(x / np.float32(scale)).astype(np.int64)
        assert (np.abs(x / scale % 1) == 0.5).sum() == 254 * 16
        np.testing.assert_array_equal(q.numpy(), k)
        assert s_x.item() == np.float32(127 * scale) / np.float32(127)
    if case == "all_zero":
        assert s_x.item() == np.float32(1e-8) / np.float32(127) and not q.any()


def test_tile_plan_covers_every_decode_conv_class():
    """tile_plan over every conv class of chip_smoke.VAE_CONVS (ragged H 60
    and W 104, Cout 3, Cin 16, kt 1), both kinds: the tiles cover the
    output, padded, never short; the tile is one the kernel has (n_tile 96,
    or 8 for the head's Cout 3; 16 or 24 rows, the one that pads H least,
    within TMA's 256-row box); the L2 -> SM bytes are the halo boxes plus
    every tile's weights."""
    import chip_smoke as cs
    for name, tin, h, w, cin, cout, kt, _, _ in cs.VAE_CONVS:
        for int8 in (False, True):
            plan = thc.tile_plan(tin, h, w, cin, cout, kt, int8)
            t_out, esz = tin - kt + 1, 1 if int8 else 2
            assert plan.n_tile == (8 if cout == 3 else 96), name
            assert plan.wgs in (2, 3) and plan.rows == 8 * plan.wgs <= 254, name
            tiles_h, tiles_w = -(-h // plan.rows), -(-w // 16)
            assert tiles_h * plan.rows >= h > (tiles_h - 1) * plan.rows, name
            assert plan.rows == (16 if h == 60 else 24), name
            n_nt = -(-cout // plan.n_tile)
            assert plan.tiles == t_out * tiles_h * tiles_w * n_nt, name
            assert plan.tiles * plan.rows * 16 * plan.n_tile >= t_out * h * w * cout
            assert plan.halo_bytes == plan.tiles * kt * (plan.rows + 2) * 18 * cin * esz
            assert plan.weight_bytes == t_out * tiles_h * tiles_w * kt * 9 * cin * esz * cout
            assert plan.l2_bytes == plan.halo_bytes + plan.weight_bytes
    # the hottest class: ~9.6 GB of L2 -> SM in bf16 (the old 8 x 16-pixel
    # tile by 32 channels: 112320 CTAs x 9 stages x 29952 bytes = 30.3 GB)
    hot = thc.tile_plan(14, 480, 832, 96, 96, 3, False)
    assert hot.wgs == 3 and hot.tiles == 12480 and 9e9 < hot.l2_bytes < 1e10


def _jax_tree(cfg):
    """The JAX package's CausalVAE parameters from a key, with the attention
    output projections (zeros at init) drawn at random so the attention
    blocks change the decode."""
    vae = jvae.CausalVAE(cfg, key=jax.random.key(0))
    params = jax.tree.map(np.asarray, vae.params)
    rng = np.random.default_rng(5)
    proj = params["decoder"]["middle"]["attn"]["proj"]
    proj["w"] = (rng.standard_normal(proj["w"].shape) * 0.1).astype(np.float32)
    proj["b"] = (rng.standard_normal(proj["b"].shape) * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def tiny():
    cfg = jvae.VAEConfig(**TINY)
    params = _jax_tree(cfg)
    z = (np.random.default_rng(1).standard_normal((1, 3, 8, 12, 4)) * 0.3
         ).astype(np.float32)
    return cfg, params, z


def _decode_jax(cfg, params, z, conv_impl, upsample_impl, chunk=2):
    try:
        jvae.set_vae_conv_impl(conv_impl, interpret_ok=True)
        jvae.set_vae_upsample_impl(upsample_impl)
        vae = jvae.CausalVAE(cfg, params=jax.tree.map(jnp.asarray, params))
        return np.asarray(vae.decode(jnp.asarray(z), chunk=chunk))
    finally:
        jvae.set_vae_conv_impl("xla")
        jvae.set_vae_upsample_impl("repeat")


def _port_vae(cfg, params, conv_impl="xla", upsample_impl="repeat"):
    return tvae.CausalVAE(tvae.VAEConfig(**TINY), params_from_numpy(params, "cpu",
                                                                    torch.float32),
                          dtype=torch.float32, device="cpu", conv_impl=conv_impl,
                          upsample_impl=upsample_impl)


@pytest.mark.parametrize("upsample_impl", ["repeat", "phase"])
@pytest.mark.parametrize("conv_impl", ["xla", "shifted_matmul", "halo", "halo_w8a8"])
def test_decode_matches_jax(tiny, conv_impl, upsample_impl):
    """A 3-frame decode in chunks of 2 (the first chunk's 'Rep' frame, then
    the temporal cache) through every conv impl and both upsample impls,
    against the JAX decode with the same switches (the halo kernels in
    interpret mode): float32, 1e-4 (convs that sum in other orders through
    the decoder); halo_w8a8 within W8A8_DECODE_RTOL / W8A8_DECODE_MAX."""
    cfg, params, z = tiny
    want = _decode_jax(cfg, params, z, conv_impl, upsample_impl)
    vae = _port_vae(cfg, params, conv_impl, upsample_impl)
    got = vae.decode(torch.from_numpy(z), chunk=2).numpy()
    assert got.shape == want.shape == (1, 5, 16, 24, 3)
    if conv_impl != "halo_w8a8":
        np.testing.assert_allclose(got, want, **DECODE_TOL)
    else:
        assert np.linalg.norm(got - want) <= W8A8_DECODE_RTOL * np.linalg.norm(want)
        assert np.abs(got - want).max() <= W8A8_DECODE_MAX * np.abs(want).max()


def test_halo_impls_route_to_the_halo_conv(tiny, monkeypatch):
    """The JAX gate: `halo` takes the 3x3x3 convs of frames with H*W >= 256
    only, `halo_w8a8` the 1x3x3 upsample conv as well; `xla` neither."""
    cfg, params, z = tiny
    seen = []
    for impl, name in (("halo", "halo_conv3d"), ("halo_w8a8", "halo_conv3d_w8a8")):
        orig = getattr(tvae, name)
        monkeypatch.setattr(tvae, name, lambda x, w, b, packed=None, _o=orig, _i=impl: (
            seen.append((_i, tuple(w.shape[:3]), x.shape[1] * x.shape[2])),
            _o(x, w, b, packed=packed))[1])
    for impl in ("xla", "halo", "halo_w8a8"):
        _port_vae(cfg, params, impl).decode(torch.from_numpy(z), chunk=3)
    assert {s[0] for s in seen} == {"halo", "halo_w8a8"}
    assert all(hw >= 256 for _, _, hw in seen)
    assert {k for i, k, _ in seen if i == "halo"} == {(3, 3, 3)}
    assert {k for i, k, _ in seen if i == "halo_w8a8"} == {(3, 3, 3), (1, 3, 3)}
    # 2 res blocks' 4 convs + the head conv at 16x24; w8a8 adds the upsample conv
    assert sum(i == "halo" for i, _, _ in seen) == 5
    assert sum(i == "halo_w8a8" for i, _, _ in seen) == 6


@pytest.mark.parametrize("conv_impl", ["halo", "halo_w8a8"])
def test_packed_halo_weights_decode_as_unpacked(tiny, conv_impl):
    """The weights CausalVAE lays out once on the card: every conv of the
    halo gate's class (3x3x3; under halo_w8a8 1x3x3 too) gets one, at every
    resolution (the H*W >= 256 part of the gate is the input's), no other
    conv does, and the decode through them equals the decode without."""
    cfg, params, z = tiny
    plain = _port_vae(cfg, params, conv_impl)
    vae = _port_vae(cfg, params, conv_impl)
    tvae._pack_halo_weights(vae.params, conv_impl)
    leaves = _leaves(vae.params)
    packed = {p[:p.index("packed")] for p, _ in leaves if "packed" in p}
    kinds = {(3, 3, 3), (1, 3, 3)} if conv_impl == "halo_w8a8" else {(3, 3, 3)}
    want = {p[:-1] for p, t in leaves
            if p[-1] == "w" and "packed" not in p and tuple(t.shape[:3]) in kinds}
    assert packed == want and len(want) >= 5
    assert torch.equal(vae.decode(torch.from_numpy(z), chunk=2),
                       plain.decode(torch.from_numpy(z), chunk=2))


def test_chunked_decode_equals_frame_by_frame(tiny):
    """Decoding 3 latent frames in one chunk equals decoding them one at a
    time (the temporal caches carry the context): float32, 1e-5."""
    cfg, params, z = tiny
    vae = _port_vae(cfg, params)
    whole = vae.decode(torch.from_numpy(z), chunk=3)
    frames = vae.decode(torch.from_numpy(z), chunk=1)
    np.testing.assert_allclose(whole.numpy(), frames.numpy(), rtol=1e-5, atol=1e-5)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def test_vae_param_bridge_and_seeded_init(tiny):
    """params_from_numpy walks the decoder's `upsamples` list and keeps every
    leaf's value; init_vae_params draws a tree of the JAX init's structure
    and shapes (encoder, decoder and both 1x1x1 convs), from its
    distributions (U(+-1/sqrt(fan_in)) convs, zero attention projections,
    unit gammas)."""
    cfg, params, _ = tiny
    bridged = _leaves(params_from_numpy(params, "cpu", torch.float32))
    want = _leaves(params)
    assert [p for p, _ in bridged] == [p for p, _ in want]
    for (_, t), (_, j) in zip(bridged, want):
        np.testing.assert_array_equal(t.numpy(), j)
    seeded = init_vae_params(tvae.VAEConfig(**TINY), torch.Generator().manual_seed(0),
                             device="cpu")
    jdec = {"encoder": jvae.init_encoder(jax.random.key(2), cfg),
            "decoder": jvae.init_decoder(jax.random.key(1), cfg),
            "conv1": params["conv1"], "conv2": params["conv2"]}
    assert [(p, tuple(t.shape)) for p, t in _leaves(seeded)] == \
        [(p, tuple(a.shape)) for p, a in _leaves(jdec)]
    head = seeded["decoder"]["head_conv"]["w"]
    bound = 1 / np.sqrt(27 * cfg.dim)
    assert head.abs().max() <= bound and head.std() > bound / 3
    assert not seeded["decoder"]["middle"]["attn"]["proj"]["w"].any()
    assert (seeded["decoder"]["head_norm"]["gamma"] == 1).all()



# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_enc(tiny):
    """The tiny VAE's tree with the encoder's attention output projection
    drawn too, and a 9-frame clip of 16x24 pixels in [-1, 1] (the halo gate
    takes the convs at full resolution: H*W = 384)."""
    cfg, params, _ = tiny
    params = jax.tree.map(np.array, params)
    proj = params["encoder"]["middle"]["attn"]["proj"]
    rng = np.random.default_rng(6)
    proj["w"] = (rng.standard_normal(proj["w"].shape) * 0.1).astype(np.float32)
    video = rng.uniform(-1, 1, (1, 9, 16, 24, 3)).astype(np.float32)
    return cfg, params, video


def _ctx(pkg, cache, first):
    if pkg is jvae:
        return jvae._CacheCtx(cache, first)
    return tvae._CacheCtx(cache, first, "xla", "repeat")


@pytest.mark.parametrize("mode", ["downsample2d", "downsample3d"])
def test_resample_downsample_matches_jax(mode):
    """resample's downsample modes over three chunks (1, then 4, then 4
    frames: the first chunk seeds the temporal cache, the later ones run
    the stride-2 time conv on it): the outputs and the carried cache."""
    rng = np.random.default_rng(8)
    c = 16
    p = {"conv": {"w": rng.standard_normal((1, 3, 3, c, c)).astype(np.float32) * 0.1,
                  "b": rng.standard_normal((c,)).astype(np.float32) * 0.1}}
    if mode == "downsample3d":
        p["time_conv"] = {"w": rng.standard_normal((3, 1, 1, c, c)).astype(np.float32) * 0.1,
                          "b": rng.standard_normal((c,)).astype(np.float32) * 0.1}
    tp = params_from_numpy(p, "cpu", torch.float32)
    jcache = tcache = None
    for i, t in enumerate((1, 4, 4)):
        x = rng.standard_normal((1, t, 10, 14, c)).astype(np.float32)
        jctx, tctx = _ctx(jvae, jcache, i == 0), _ctx(tvae, tcache, i == 0)
        want = jvae.resample(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jctx, mode)
        got = tvae.resample(tp, torch.from_numpy(x), tctx, mode)
        assert got.shape == want.shape == (1, 2 if i and mode == "downsample3d" else t,
                                           5, 7, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
        jcache, tcache = jctx.cache, tctx.cache
        assert sorted(tcache) == sorted(jcache)
        for k in jcache:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **DECODE_TOL)


def test_encoder_apply_chunk_by_chunk(tiny_enc):
    """encoder_apply over a 9-frame clip in chunks of 1, 4, 4 with the
    caches carried: each chunk's output [1, t', 8, 12, 2z] against JAX."""
    cfg, params, video = tiny_enc
    tp = params_from_numpy(params["encoder"], "cpu", torch.float32)
    jp = jax.tree.map(jnp.asarray, params["encoder"])
    jcache = tcache = None
    pos = 0
    for i, n in enumerate((1, 4, 4)):
        x = video[:, pos:pos + n]
        pos += n
        jctx, tctx = _ctx(jvae, jcache, i == 0), _ctx(tvae, tcache, i == 0)
        want = jvae.encoder_apply(jp, jnp.asarray(x), jctx)
        got = tvae.encoder_apply(tp, torch.from_numpy(x), tctx)
        assert got.shape == want.shape == (1, 1 if i == 0 else 2, 8, 12, 2 * cfg.z_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
        jcache, tcache = jctx.cache, tctx.cache


@pytest.mark.parametrize("frames", [1, 5, 9])
@pytest.mark.parametrize("conv_impl", ["xla", "halo"])
def test_encode_matches_jax(tiny_enc, conv_impl, frames):
    """CausalVAE.encode of 1, 5 and 9 frames (the tiny config halves time
    once: 1, 3 and 5 latent frames) through "xla" and "halo" (the JAX halo
    kernel in interpret mode; the port's plain version, Cin 3 at the input
    conv), normalised posterior means against JAX at DECODE_TOL."""
    cfg, params, video = tiny_enc
    x = video[:, :frames]
    try:
        jvae.set_vae_conv_impl(conv_impl, interpret_ok=True)
        want = np.asarray(jvae.CausalVAE(cfg, params=jax.tree.map(jnp.asarray, params))
                          .encode(jnp.asarray(x)))
    finally:
        jvae.set_vae_conv_impl("xla")
    got = _port_vae(cfg, params, conv_impl).encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 1 + (frames - 1) // 2, 8, 12, cfg.z_dim)
    np.testing.assert_allclose(got, want, **DECODE_TOL)


def test_encode_refuses_other_frame_counts(tiny_enc):
    cfg, params, video = tiny_enc
    vae = _port_vae(cfg, params)
    for t in (2, 4, 8):
        with pytest.raises(ValueError, match="1 \\+ 4k"):
            vae.encode(torch.from_numpy(video[:, :t]))
    with pytest.raises(ValueError, match="no encoder"):
        tvae.CausalVAE(tvae.VAEConfig(**TINY), {k: v for k, v in params_from_numpy(
            params, "cpu", torch.float32).items() if k in ("decoder", "conv2")},
            dtype=torch.float32, device="cpu").encode(torch.from_numpy(video[:, :1]))


def test_encoder_halo_routing(tiny_enc, monkeypatch):
    """The gate on the encoder: "halo" and "halo_w8a8" take the same convs
    (the stride-1 3x3x3 ones at H*W >= 256, the RGB input conv with Cin 3
    among them; the stride-2 downsample convs stay on F.conv3d, so W8A8
    adds no 1x3x3 conv), the same number in every chunk."""
    cfg, params, video = tiny_enc
    seen = {}
    for impl, name in (("halo", "halo_conv3d"), ("halo_w8a8", "halo_conv3d_w8a8")):
        orig = getattr(tvae, name)
        monkeypatch.setattr(tvae, name, lambda x, w, b, packed=None, _o=orig, _i=impl: (
            seen[_i].append((tuple(w.shape[:4]), x.shape[1] * x.shape[2])),
            _o(x, w, b, packed=packed))[1])
    for impl in ("halo", "halo_w8a8"):
        seen[impl] = []
        _port_vae(cfg, params, impl).encode(torch.from_numpy(video[:, :5]))
    assert seen["halo"] == seen["halo_w8a8"]
    assert all(k[:3] == (3, 3, 3) and hw >= 256 for k, hw in seen["halo"])
    # per chunk: the input conv (Cin 3) and the full-resolution res block's
    # two convs
    assert [k[3] for k, _ in seen["halo"]] == [3, 16, 16] * 2


@pytest.mark.parametrize("cin,w8a8,padded", [(3, False, 8), (3, True, 16), (24, True, 32),
                                             (12, False, 16), (16, False, 16)])
def test_pack_weight_pads_cin_with_zero_weights(cin, w8a8, padded):
    """Cin that is not a multiple of 8 (bf16) or 16 (W8A8): the operand is
    [kt, 9, Cout, Cin'] with Cin' the next multiple, wk[dt, 3 dh + dw, n, c]
    = w[dt, dh, dw, c, n] below Cin and 0 above, built directly here; s_w is
    the unpadded weight's; the wrappers on CPU tensors take it and return
    the plain version's output."""
    x, wt, b = map(torch.from_numpy, _conv_inputs(3, 6, 7, cin, 24, 3, seed=13))
    packed = thc.pack_weight(wt, w8a8=w8a8)
    if w8a8:
        w_el, s_w = thc.quantize_conv_weight(wt)
        assert torch.equal(packed.s_w, s_w)
    else:
        w_el = wt.to(torch.bfloat16)
    want = torch.zeros(3, 9, 24, padded, dtype=w_el.dtype)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                for c in range(cin):
                    want[dt, 3 * dh + dw, :, c] = w_el[dt, dh, dw, c, :]
    assert packed.wk.is_contiguous() and thc.padded_cin(cin, 16 if w8a8 else 8) == padded
    assert torch.equal(packed.wk, want)
    kern, plain = ((thc.halo_conv3d_w8a8, thc.halo_conv3d_w8a8_reference) if w8a8
                   else (thc.halo_conv3d, thc.halo_conv3d_reference))
    assert torch.equal(kern(x, wt, b, packed=packed), plain(x, wt, b))


def test_vae_keeps_the_encoder_and_packs_its_halo_convs(tiny_enc):
    """CausalVAE keeps the encoder and conv1 beside the decoder and conv2;
    packing for the card gives the encoder's 3x3x3 convs (the RGB input
    conv's operand padded to Cin 8) their operands."""
    cfg, params, _ = tiny_enc
    vae = _port_vae(cfg, params, "halo")
    assert sorted(vae.params) == ["conv1", "conv2", "decoder", "encoder"]
    tvae._pack_halo_weights(vae.params, "halo")
    assert vae.params["encoder"]["conv1"]["packed"].wk.shape == (3, 9, 16, 8)
    assert vae.params["encoder"]["head_conv"]["packed"].wk.shape == (3, 9, 2 * cfg.z_dim, 32)
