"""The port's MAGI media, special-token and text helpers against the JAX
package's, on the CPU: `prepare_frames` (fit / crop / pad, an upscale and
a downscale), `clip_prefix_video`, `encode_prefix_latents`' padding,
`pad_special_tokens`, the caption cleaning with and without bs4, and
`MagiT5Embedder` (and `magi_text_embeddings` over it) on
`tiny_t5_v1_1_config` with a stub tokenizer.

Tolerances, each with its reason:
- the resize: the port computes `jax.image.resize(..., "bilinear")`'s
  weights (the antialiased triangle kernel) in numpy float32, rounded where
  XLA rounds them (else a weight near pixel 1000 moves by 6e-5), and applies
  them an axis at a time, where JAX contracts both axes in one einsum: the
  same float32 products summed in other orders, RESIZE_TOL = 1e-5 on values
  in [-1, 1] (measured 4e-7, also from 853x1000 and 1080x1920 to 720x720
  and 720x1280);
- the prefix latents: the tiny ViT-VAE's float32 encode, as
  tests/test_torch_magi_vae.py holds it: 2e-5;
- the token padding: the same float32 values moved, exactly equal;
- the caption cleaning: the same string operations, exactly equal;
- the T5 features: float32 through 2 layers, other summation orders:
  T5_TOL = 1e-5 (tests/test_torch_text.py's UMT5 tolerance).
"""
import builtins
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.magi import vae as jvae
from inferix_tpu.models.text import umt5 as jumt5
from inferix_tpu.pipeline import magi_media as jmedia
from inferix_tpu.pipeline import magi_tokens as jtokens
from inferix_tpu_torch.models.magi import vae as tvae
from inferix_tpu_torch.models.text import umt5 as tumt5
from inferix_tpu_torch.pipeline import magi_media as tmedia
from inferix_tpu_torch.pipeline import magi_tokens as ttokens
from inferix_tpu_torch.utils.params import params_from_numpy

RESIZE_TOL = dict(rtol=1e-5, atol=1e-5)
T5_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["fit", "crop", "pad", "unknown"])
@pytest.mark.parametrize("src,dst", [((9, 14), (32, 24)), ((64, 40), (16, 24)),
                                     ((30, 30), (30, 30)), ((50, 20), (20, 50)),
                                     ((853, 1000), (72, 128))],
                         ids=["up", "down", "same", "mixed", "odd"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_prepare_frames_matches_jax(policy, src, dst, dtype):
    rng = np.random.default_rng(sum(src) + sum(dst))
    frames = rng.integers(0, 256, (2, *src, 3)).astype(np.uint8)
    if dtype == "float32":
        frames = frames.astype(np.float32) / 127.5 - 1.0
    want = jmedia.prepare_frames(frames, *dst, aspect_policy=policy)
    got = tmedia.prepare_frames(frames, *dst, aspect_policy=policy)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


def test_process_image_and_video_match_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.testing.assert_allclose(tmedia.process_image(img, 16, 16, "crop"),
                               jmedia.process_image(img, 16, 16, "crop"), **RESIZE_TOL)
    vid = rng.integers(0, 256, (37, 12, 20, 3)).astype(np.uint8)
    got = tmedia.process_prefix_video(vid, 16, 8, 8, aspect_policy="pad")
    want = jmedia.process_prefix_video(vid, 16, 8, 8, aspect_policy="pad")
    assert got.shape == want.shape == (32, 8, 8, 3)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


@pytest.mark.parametrize("n,fps,prefix_frame,max_chunks", [
    (5, 16, None, 5), (16, 16, None, 5), (40, 16, None, 5), (200, 16, None, 5),
    (200, 16, None, 2), (40, 16, 7, 5)])
def test_clip_prefix_video_matches_jax(n, fps, prefix_frame, max_chunks):
    frames = np.arange(n)[:, None, None, None] * np.ones((1, 2, 2, 3))
    got = tmedia.clip_prefix_video(frames, fps, prefix_frame, max_chunks)
    want = jmedia.clip_prefix_video(frames, fps, prefix_frame, max_chunks)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def vaes():
    """(JAX ViTVAE, port ViTVAE) of one tiny tree."""
    cfg = jvae.tiny_vitvae_config()
    params = jax.tree.map(np.asarray, jax.jit(jvae.init_vitvae_params, static_argnums=1)(
        jax.random.key(5), cfg))
    return (jvae.ViTVAE(cfg, params=jax.tree.map(jnp.asarray, params)),
            tvae.ViTVAE(tvae.ViTVAEConfig(**dataclasses.asdict(cfg)),
                        params=params_from_numpy(params, "cpu", torch.float32), device="cpu"))


@pytest.mark.parametrize("t,chunk_width", [(1, None), (3, None), (5, 2), (8, 2), (1, 3)])
def test_encode_prefix_latents_padding(vaes, t, chunk_width):
    """T frames padded to whole latent frames (and chunks) by repeating the
    last frame, then encoded: latents against the JAX function's."""
    jv, tv = vaes
    cfg = jv.cfg
    frames = np.random.default_rng(t).uniform(-1, 1, (t, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jmedia.encode_prefix_latents(jv, frames, chunk_width))
    got = tmedia.encode_prefix_latents(tv, frames, chunk_width)
    lat_t = -(-t // cfg.patch_length)
    if chunk_width:
        lat_t = -(-lat_t // chunk_width) * chunk_width
    assert got.shape == want.shape == (1, lat_t, 4, 4, cfg.z_chans)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_pad_special_tokens_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    d = 16
    npz = tmp_path / "special_tokens.npz"
    np.savez(npz, caption_token=rng.standard_normal((1, d)),
             logo_token=rng.standard_normal((1, d)),
             other_tokens=rng.standard_normal((17, d)))
    table = ttokens.load_special_tokens(str(npz))
    jtable = jtokens.load_special_tokens(str(npz))
    assert table.keys() == jtable.keys()
    assert all(np.array_equal(table[k], jtable[k]) for k in table)
    monkeypatch.setenv("PAD_HQ", "1")
    monkeypatch.setenv("PAD_DURATION", "true")
    monkeypatch.setenv("NEG_PROMPT", "yes")
    keys = ttokens.special_token_keys_from_env()
    assert keys == jtokens.special_token_keys_from_env() == ["HQ_TOKEN", "DURATION_TOKEN"]
    neg = ttokens.negative_special_token_keys_from_env()
    assert neg == jtokens.negative_special_token_keys_from_env()
    cap = rng.standard_normal((1, 6, d)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0]], np.float32)
    for ks, max_len, left in ((keys, 7, 3), (keys, 800, 11), (neg, 9, 1)):
        want = jtokens.pad_special_tokens(cap, mask, ks, table, max_length=max_len,
                                          chunks_remaining=left)
        got = ttokens.pad_special_tokens(torch.from_numpy(cap), torch.from_numpy(mask), ks,
                                         table, max_length=max_len, chunks_remaining=left)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            assert np.array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="chunks_remaining"):
        ttokens.pad_special_tokens(torch.from_numpy(cap), torch.from_numpy(mask),
                                   ["DURATION_TOKEN"], table)
    monkeypatch.delenv("SPECIAL_TOKEN_PATH", raising=False)
    with pytest.raises(ValueError, match="path"):
        ttokens.load_special_tokens()


CAPTIONS = [
    "A Cat sitting on a MAT, 4K photo!!",
    "Visit https://example.com/pic.jpg or www.site.org for <b>FREE</b> shipping",
    "&quot;Quoted&quot; text &amp; more... #123 @someone 12345678",
    "“Smart” ‘quotes’ — dashes – and 漢字 characters 㐀",
    "click for more: page 12 of IMG1234 abc12de 1920x1080 file.mp4",
    "a_b_c_d_e underscores-and-dashes everywhere",
    "'single quoted caption'",
    "  mixed\\nnewline   spacing  ",
    "<person> walks by 10.0.0.1 at 3:45 ",
    "%20encoded%2Bplus+text",
]


def _hide_bs4(monkeypatch):
    real = builtins.__import__

    def guarded(name, *a, **k):
        if name == "bs4" or name.startswith("bs4."):
            raise ImportError("bs4 hidden")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)


@pytest.mark.parametrize("bs4", ["with_bs4", "without_bs4"])
def test_caption_cleaning_matches_jax(bs4, monkeypatch):
    if bs4 == "with_bs4":
        pytest.importorskip("bs4")
    else:
        _hide_bs4(monkeypatch)
    for c in CAPTIONS:
        assert tumt5.clean_caption(c) == jumt5.clean_caption(c), c
        for clean in (True, False):
            assert tumt5.text_preprocessing(c, clean) == jumt5.text_preprocessing(c, clean)


class StubTokenizer:
    """Words -> ids by a fixed hash (numpy arrays, the HF call's keys)."""

    def __call__(self, texts, max_length=16, **kw):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [sum(map(ord, w)) % 100 + 1 for w in t.split()][:max_length]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
def test_magi_t5_embedder_matches_jax(stream):
    cfg = jumt5.tiny_t5_v1_1_config()
    params = jax.tree.map(np.asarray, jumt5.init_umt5_params(jax.random.key(2), cfg,
                                                             dtype=jnp.float32))
    jemb = jumt5.MagiT5Embedder(cfg, params=jax.tree.map(jnp.asarray, params),
                                tokenizer=StubTokenizer(), model_max_length=12,
                                dtype=jnp.float32)
    temb = tumt5.MagiT5Embedder(tumt5.UMT5Config(**dataclasses.asdict(cfg)),
                                params=params_from_numpy(params, "cpu", torch.float32),
                                tokenizer=StubTokenizer(), model_max_length=12,
                                dtype=torch.float32, stream_layers=stream, device="cpu")
    texts = ["A <b>Red</b> fox jumps over http://x.com the lazy dog", "short one"]
    je, jm = jemb.get_text_embeddings(texts)
    te, tm = temb.get_text_embeddings(texts)
    assert te.shape == je.shape == (2, 12, cfg.dim) and te.dtype == torch.float32
    assert tm.dtype == torch.int32 and np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **T5_TOL)
    from inferix_tpu.pipeline.magi import magi_text_embeddings as jtext
    from inferix_tpu_torch.pipeline.magi import magi_text_embeddings as ttext

    (te1, tm1), (je1, jm1) = ttext(texts[0], embedder=temb), jtext(texts[0], embedder=jemb)
    assert torch.equal(te1, te[:1]) and torch.equal(tm1, tm[:1])
    np.testing.assert_allclose(te1.numpy(), np.asarray(je1), **T5_TOL)
    with pytest.raises(RuntimeError, match="tokenizer"):
        tumt5.MagiT5Embedder(tumt5.UMT5Config(**dataclasses.asdict(cfg)),
                             params=temb.params, device="cpu").get_text_embeddings(["x"])
