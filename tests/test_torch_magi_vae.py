"""The port's MAGI ViT-VAE (`inferix_tpu_torch.models.magi.vae`) and its
loader against the JAX package's, float32, on the CPU.

Weights: the reference-format state dict of tests/test_magi_vae_parity.py
(`make_vae_sd`, seeded torch draws with LayerNorms and biases off their
defaults), converted by each package's `convert_magi_vae_state_dict`;
inputs drawn with numpy from seeds. The port's attention on CPU tensors is
the plain einsum chain, the JAX package's too.

Tolerances, each with its reason:
- encode / decode against the JAX functions: the same float32 math in
  other summation orders (matmuls, the conv, the softmax), through 2
  blocks: TOL = 2e-5 (measured ~1e-6), as tests/test_magi_vae_parity.py
  holds the JAX package to the reference's torch at 2e-4;
- the rope tables: the same numpy code, exactly equal;
- the pos-embed resize: the port's 2-tap resample against the JAX one and
  against `F.interpolate(mode="trilinear", align_corners=False)`, float32
  with one rounding order each: 1e-6;
- the loader: the same float32 values moved, exactly equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inferix_tpu.models.magi import vae as jvae
from inferix_tpu.utils import checkpoint as jckpt
from inferix_tpu_torch.models.magi import vae as tvae
from inferix_tpu_torch.utils import checkpoint as tckpt

from test_magi_vae_parity import TINY, make_vae_sd

TOL = dict(rtol=2e-5, atol=2e-5)
NO_ROPE = dataclasses.replace(TINY, embed_dim=64, num_heads=4, ln_in_attn=False,
                              use_rope=False, use_final_proj=False)


def _tcfg(cfg):
    return tvae.ViTVAEConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["rope", "no_rope"])
def pair(request):
    """(JAX ViTVAE, port ViTVAE) of one state dict."""
    cfg = TINY if request.param == "rope" else NO_ROPE
    sd = make_vae_sd(cfg)
    jv = jvae.ViTVAE(cfg, params=jckpt.convert_magi_vae_state_dict(sd, cfg))
    tv = tvae.ViTVAE(_tcfg(cfg), params=tckpt.convert_magi_vae_state_dict(sd, _tcfg(cfg), "cpu"),
                     device="cpu")
    return jv, tv


def _video(cfg, t, h, w, seed=7):
    return (np.random.default_rng(seed).standard_normal((1, t, h, w, cfg.in_chans))
            .astype(np.float32) * 0.5)


@pytest.mark.parametrize("geom", [(4, 16, 16), (6, 24, 8), (2, 8, 16)],
                         ids=["pretrain", "resized", "shrunk"])
def test_encode_decode_match_jax(pair, geom):
    """encode_moments, encode (the mode) and decode (clipped; _decode
    unclipped) at the pretrain geometry and at resized ones (the pos-embed
    resize and the rope tables built for the actual grid)."""
    jv, tv = pair
    video = _video(jv.cfg, *geom)
    jm = np.asarray(jv.encode_moments(jnp.asarray(video)))
    tm = tv.encode_moments(torch.from_numpy(video))
    np.testing.assert_allclose(tm.numpy(), jm, err_msg="moments", **TOL)
    jz = np.asarray(jv.encode(jnp.asarray(video)))
    tz = tv.encode(torch.from_numpy(video))
    np.testing.assert_allclose(tz.numpy(), jz, err_msg="encode", **TOL)
    z = np.random.default_rng(8).standard_normal(jz.shape).astype(np.float32)
    jraw = np.asarray(jax.jit(jv._decode_impl)(jv.params, jnp.asarray(z)))
    np.testing.assert_allclose(tv._decode(torch.from_numpy(z)).numpy(), jraw,
                               err_msg="decode", **TOL)
    np.testing.assert_allclose(tv.decode(torch.from_numpy(z)).numpy(),
                               np.asarray(jv.decode(jnp.asarray(z))), err_msg="clipped", **TOL)


def test_single_frame_encode(pair):
    jv, tv = pair
    img = _video(jv.cfg, 1, 16, 16, seed=9)
    want = np.asarray(jv.encode(jnp.asarray(img)))
    got = tv.encode(torch.from_numpy(img))
    assert got.shape == want.shape == (1, 1, 4, 4, jv.cfg.z_chans)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_posterior_sample_with_jax_eps(pair, monkeypatch):
    """encode with a generator samples mean + std * eps: the port's
    `_draw_eps` patched to return the JAX draw of the same key."""
    jv, tv = pair
    video = _video(jv.cfg, 4, 16, 16, seed=10)
    key = jax.random.key(4)
    monkeypatch.setattr(tvae.ViTVAE, "_draw_eps", lambda self, g, shape, dtype: torch.tensor(
        np.asarray(jax.random.normal(key, tuple(shape), jnp.float32))))
    want = np.asarray(jv.encode(jnp.asarray(video), rng=key))
    got = tv.encode(torch.from_numpy(video), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(got.numpy(), np.asarray(jv.encode(jnp.asarray(video))), atol=1e-3)


@pytest.mark.parametrize("feat", [(4, 16, 16), (6, 90, 90), (6, 90, 160), (1, 3, 5)])
@pytest.mark.parametrize("head_dim", [48, 24])
def test_rope_tables_equal(feat, head_dim):
    for a, b in zip(tvae.vitvae_rope_tables(feat, head_dim, (4, 16, 16)),
                    jvae.vitvae_rope_tables(feat, head_dim, (4, 16, 16))):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_apply_rot_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 3, 30)).astype(np.float32)   # rot 24 of 30 dims
    sin, cos = jvae.vitvae_rope_tables((1, 3, 4), 24, (4, 16, 16))
    want = np.asarray(jvae._apply_rot_interleaved(jnp.asarray(x), jnp.asarray(sin),
                                                  jnp.asarray(cos)))
    got = tvae._apply_rot_interleaved(torch.from_numpy(x), torch.from_numpy(sin),
                                      torch.from_numpy(cos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_matches_einsum_chain(dtype, monkeypatch):
    """`vit_attention` on CPU tensors (the plain version), also a few query
    rows at a time, against the JAX block's einsum chain on the same
    values: float32 logits and softmax, probabilities in v's dtype."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 37, 3, 48)).astype(np.float32)).to(dtype)
               for _ in range(3))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv_ = (jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v))
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk, preferred_element_type=jnp.float32) * 48 ** -0.5
    probs = jax.nn.softmax(logits, axis=-1).astype(jv_.dtype)
    want = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", probs, jv_).astype(jnp.float32))
    got = tvae.vit_attention(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    monkeypatch.setattr(tvae, "VIT_PLAIN_ROWS", 5)
    assert torch.equal(tvae.vit_attention(q, k, v), got)


@pytest.mark.parametrize("out", [(6, 3, 2), (2, 8, 5), (4, 4, 4)])
def test_pos_embed_resize(out):
    """The trilinear resize against the JAX one and against torch's
    trilinear interpolate (align_corners=False, no antialias)."""
    cfg = dataclasses.replace(TINY, video_size=16, patch_size=4)   # 2 x 4 x 4 grid
    rng = np.random.default_rng(13)
    pos = rng.standard_normal((cfg.num_patches + 1, cfg.embed_dim)).astype(np.float32)
    want = np.asarray(jvae._pos_embed_for(cfg, jnp.asarray(pos), out))
    got = tvae._pos_embed_for(_tcfg(cfg), torch.from_numpy(pos), out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    grid = torch.from_numpy(pos[1:]).reshape(cfg.latent_length, cfg.latent_size,
                                              cfg.latent_size, -1).permute(3, 0, 1, 2)[None]
    ref = F.interpolate(grid, size=out, mode="trilinear", align_corners=False)
    np.testing.assert_allclose(got[1:].numpy(), ref[0].permute(1, 2, 3, 0).reshape(
        -1, cfg.embed_dim).numpy(), rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[0].numpy(), pos[0])


def test_init_vitvae_params_tree_matches_jax():
    cfg = NO_ROPE
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        lambda: jvae.init_vitvae_params(jax.random.key(0), cfg)))
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
                       tvae.init_vitvae_params(_tcfg(cfg), torch.Generator().manual_seed(0),
                                               "cpu"))
    assert got == want


def _write_vae_dir(path, cfg, sd, fmt, nest):
    dd = {k: getattr(cfg, k) for k in ("video_size", "video_length", "patch_size",
                                       "patch_length", "z_chans", "embed_dim", "depth",
                                       "num_heads", "ln_in_attn", "use_rope",
                                       "use_final_proj", "with_cls_token", "double_z",
                                       "qkv_bias")}
    dd["unknown_key"] = 1
    (path / "config.json").write_text(json.dumps({"ddconfig": dd} if nest else dd))
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()},
                  str(path / "diffusion_pytorch_model.safetensors"))
    else:
        torch.save(sd, path / "pytorch_model.bin")


@pytest.mark.parametrize("fmt,nest", [("safetensors", True), ("bin", False)])
def test_load_magi_vae_matches_jax(tmp_path, fmt, nest):
    """A VAE directory written here (config.json, its ddconfig nested or
    flat, and the weights as safetensors or .bin) through both loaders:
    configs equal, every leaf equal, and the port's encode equal to the
    JAX one."""
    cfg = TINY
    sd = make_vae_sd(cfg)
    _write_vae_dir(tmp_path, cfg, sd, fmt, nest)
    jv = jckpt.load_magi_vae(str(tmp_path), scale_factor=1.0)
    tv = tckpt.load_magi_vae(str(tmp_path), device="cpu", scale_factor=1.0)
    assert dataclasses.asdict(tv.cfg) == dataclasses.asdict(jv.cfg)
    assert tvae.ViTVAEConfig(**dataclasses.asdict(cfg)) == tv.cfg
    jleaves = jax.tree_util.tree_leaves_with_path(jv.params)
    tflat = dict(jax.tree_util.tree_leaves_with_path(tv.params))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        t = tflat[path]
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), np.asarray(leaf)), path
    video = _video(cfg, 4, 16, 16)
    np.testing.assert_allclose(tv.encode(torch.from_numpy(video)).numpy(),
                               np.asarray(jv.encode(jnp.asarray(video))), **TOL)


def test_vitvae_config_from_ddconfig():
    dd = dict(video_size=16, video_length=4, patch_size=4, patch_length=2, embed_dim=48,
              depth=2, num_heads=2, z_chans=4, ln_in_attn=True, use_rope=True,
              with_cls_token=True, use_final_proj=True, double_z=True, qkv_bias=False,
              other=3)
    got = tckpt.vitvae_config_from_ddconfig(dd, scale_factor=1.0)
    want = jckpt.vitvae_config_from_ddconfig(dd, scale_factor=1.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(FileNotFoundError):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            with open(f"{d}/config.json", "w") as f:
                json.dump(dd, f)
            tckpt.load_magi_vae(d, device="cpu")
