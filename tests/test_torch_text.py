"""The port's text and image encoders against the JAX package's, on the CPU:
UMT5 / t5-v1_1 (`models/text/umt5.py`) with its relative buckets, both bias
layouts, `WanTextEncoder`, the layer streaming and the HF converter; the CLIP
vision tower; XLM-RoBERTa with its CLIP head and converter.

Both packages start from the same parameters (the JAX initialisers, carried
across as numpy) and the same numpy-seeded ids and images. Tolerances:
float32 1e-5 (absolute and relative; O(1) features from a few layers of
O(64)-term float32 sums in other orders); bf16 2e-2 in norm, relative to the
float32 reference's norm, for both packages (each framework rounds its bf16
products and elementwise results at the same points, in its own kernels);
the streamed runs bit-equal to the resident ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.text import clip_vision as jclip
from inferix_tpu.models.text import umt5 as jumt5
from inferix_tpu.models.text import xlm_roberta as jxlm
from inferix_tpu_torch.models.text import clip_vision as tclip
from inferix_tpu_torch.models.text import umt5 as tumt5
from inferix_tpu_torch.models.text import xlm_roberta as txlm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_NORM_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(tree):
    """A JAX tree as torch tensors on the CPU, bf16 carried as bf16."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dtype, ref=None):
    """float32: elementwise; bf16: the norm of the difference relative to
    the float32 reference's norm (`ref`, else `want`)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        scale = np.linalg.norm(_np(ref) if ref is not None else want)
        err = np.linalg.norm(got - want) / scale
        assert err <= BF16_NORM_TOL, err


def _ids(rng, vocab, b, n, lengths):
    ids = rng.integers(2, vocab, (b, n))
    mask = np.zeros((b, n), np.int32)
    for i, length in enumerate(lengths):
        mask[i, :length] = 1
    return ids.astype(np.int32), mask


class StubTok:
    """A deterministic tokenizer: word i of a prompt -> (crc32(word) % 100)
    + 1, padded with 0 to max_length."""

    def __call__(self, prompts, **kw):
        import zlib
        n = kw.get("max_length", 16)
        ids = np.zeros((len(prompts), n), np.int64)
        mask = np.zeros((len(prompts), n), np.int64)
        for i, p in enumerate(prompts):
            toks = [zlib.crc32(w.encode()) % 100 + 1 for w in p.split()][:n]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


# ---------------------------------------------------------------------------
# UMT5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,nb,md", [(12, 8, 16), (40, 32, 128), (513, 32, 128)])
def test_relative_position_buckets(L, nb, md):
    np.testing.assert_array_equal(tumt5.relative_position_buckets(L, nb, md),
                                  jumt5.relative_position_buckets(L, nb, md))


@pytest.mark.parametrize("shared", [False, True], ids=["umt5", "t5_v1_1"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_umt5_encode(shared, dtype):
    """umt5_encode with the per-layer bias (UMT5) and the shared table
    (t5-v1_1), a padded row, float32 and bf16."""
    jdt, tdt = DTYPES[dtype]
    cfg = jumt5.tiny_t5_v1_1_config() if shared else jumt5.tiny_umt5_config()
    tcfg = tumt5.tiny_t5_v1_1_config() if shared else tumt5.tiny_umt5_config()
    assert tcfg == tumt5.UMT5Config(**vars(cfg))
    jp = jumt5.init_umt5_params(jax.random.key(3), cfg, dtype=jdt)
    tp = _to_torch(jp)
    ids, mask = _ids(np.random.default_rng(0), cfg.vocab_size, 2, 10, (10, 4))
    want = jumt5.umt5_encode(jp, cfg, jnp.asarray(ids), jnp.asarray(mask))
    got = tumt5.umt5_encode(tp, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == tdt
    ref = None
    if dtype == "bfloat16":
        ref = jumt5.umt5_encode(jax.tree.map(lambda a: a.astype(jnp.float32), jp), cfg,
                                jnp.asarray(ids), jnp.asarray(mask))
    _check(got, want, dtype, ref)


def test_umt5_padded_tokens_do_not_leak():
    """A padded token's id moves no real position's feature (the -1e9 mask)."""
    cfg = tumt5.tiny_umt5_config()
    tp = tumt5.init_umt5_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    ids, mask = _ids(np.random.default_rng(1), cfg.vocab_size, 2, 10, (10, 4))
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    out = tumt5.umt5_encode(tp, cfg, ids, mask)
    ids2 = ids.clone()
    ids2[1, 7] = 5
    out2 = tumt5.umt5_encode(tp, cfg, ids2, mask)
    torch.testing.assert_close(out2[1, :4], out[1, :4], rtol=0, atol=1e-6)
    assert not torch.equal(out2[1, 7], out[1, 7])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wan_text_encoder(dtype):
    """WanTextEncoder over a stub tokenizer against the JAX one: padded
    positions exactly 0, the real ones as the JAX features."""
    jdt, tdt = DTYPES[dtype]
    cfg = jumt5.tiny_umt5_config()
    jp = jumt5.init_umt5_params(jax.random.key(1), cfg, dtype=jdt)
    jenc = jumt5.WanTextEncoder(cfg, params=jp, tokenizer=StubTok(), text_len=16, dtype=jdt)
    tenc = tumt5.WanTextEncoder(tumt5.tiny_umt5_config(), params=_to_torch(jp),
                                tokenizer=StubTok(), text_len=16, dtype=tdt, device="cpu")
    prompts = ["hello world and a boat", "a"]
    got, want = tenc(prompts), jenc(prompts)
    assert got.shape == (2, 16, cfg.dim) and got.dtype == tdt
    assert float(got[1, 1:].abs().max()) == 0.0 and float(got[0, 5:].abs().max()) == 0.0
    assert float(got[0, :5].abs().max()) > 0.0
    ref = None
    if dtype == "bfloat16":
        ref = jumt5.WanTextEncoder(cfg, params=jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                                   tokenizer=StubTok(), text_len=16,
                                   dtype=jnp.float32)(prompts)
    _check(got, want, dtype, ref)


def test_wan_text_encoder_without_tokenizer_raises():
    enc = tumt5.WanTextEncoder(tumt5.tiny_umt5_config(), device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no tokenizer"):
        enc(["a"])


@pytest.mark.parametrize("shared", [False, True], ids=["umt5", "t5_v1_1"])
def test_stream_layers_bit_equal_to_resident(shared):
    """stream_layers=True (blocks, embedding and shared table on the host,
    streamed a layer at a time) gives the resident run's bits; the encoder
    class moves the tower to the host and gives the same features."""
    cfg = tumt5.tiny_t5_v1_1_config() if shared else tumt5.tiny_umt5_config()
    tp = tumt5.init_umt5_params(cfg, torch.Generator().manual_seed(2), "cpu", torch.float32)
    ids, mask = _ids(np.random.default_rng(2), cfg.vocab_size, 1, 6, (4,))
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    want = tumt5.umt5_encode(tp, cfg, ids, mask)
    got = tumt5.umt5_encode(tp, cfg, ids, mask, stream_layers=True)
    assert torch.equal(got, want)
    a = tumt5.WanTextEncoder(cfg, params=tp, tokenizer=StubTok(), text_len=8,
                             dtype=torch.float32, device="cpu")
    b = tumt5.WanTextEncoder(cfg, params=tp, tokenizer=StubTok(), text_len=8,
                             dtype=torch.float32, device="cpu", stream_layers=True)
    assert torch.equal(b(["a small boat"]), a(["a small boat"]))


def _hf_pair(shared, seed):
    from transformers import T5Config, T5EncoderModel, UMT5Config, UMT5EncoderModel

    cfg = jumt5.tiny_t5_v1_1_config() if shared else jumt5.tiny_umt5_config()
    hf_cls, model_cls = (T5Config, T5EncoderModel) if shared else (UMT5Config, UMT5EncoderModel)
    hf_cfg = hf_cls(vocab_size=cfg.vocab_size, d_model=cfg.dim, d_kv=cfg.head_dim,
                    d_ff=cfg.dim_ffn, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                    relative_attention_num_buckets=cfg.num_buckets,
                    relative_attention_max_distance=cfg.max_dist,
                    feed_forward_proj="gated-gelu", is_encoder_decoder=False,
                    use_cache=False, tie_word_embeddings=False, dropout_rate=0.0)
    torch.manual_seed(seed)
    return cfg, model_cls(hf_cfg).eval().float()


@pytest.mark.parametrize("shared", [False, True], ids=["umt5", "t5_v1_1"])
def test_convert_t5_encoder_state_dict(shared):
    """An HF encoder's state dict through both converters: the same trees,
    and the port's features equal HF's at the real positions."""
    cfg, model = _hf_pair(shared, 11 if shared else 12)
    sd = model.state_dict()
    tcfg = tumt5.UMT5Config(**vars(cfg))
    tp = tumt5.convert_t5_encoder_state_dict(sd, tcfg, dtype=torch.float32, device="cpu")
    jp = jumt5.convert_t5_encoder_state_dict(sd, cfg, dtype=jnp.float32)
    assert ("shared_pos_emb" in tp) == shared and ("pos_emb" in tp["blocks"]) != shared
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_np(b), np.asarray(a)), jp,
                 jax.tree.map(lambda x: x, tp))
    ids = np.array([[3, 9, 27, 100, 0, 0], [5, 1, 0, 0, 0, 0]], np.int64)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.int64)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    got = _np(tumt5.umt5_encode(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask)))
    m = mask[..., None].astype(bool)
    np.testing.assert_allclose(np.where(m, got, 0), np.where(m, want, 0), rtol=2e-4, atol=2e-4)


def test_init_umt5_params_distributions():
    """The port's initialiser: the JAX tree's structure, shapes and dtypes,
    and its scales (std within 5%)."""
    cfg = tumt5.UMT5Config(vocab_size=512, dim=128, dim_attn=128, dim_ffn=256,
                           num_heads=4, num_layers=2, num_buckets=8, max_dist=16)
    jp = jumt5.init_umt5_params(jax.random.key(0), jumt5.UMT5Config(**vars(cfg)),
                                dtype=jnp.bfloat16)
    tp = tumt5.init_umt5_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)

    def check(a, b):
        assert tuple(a.shape) == tuple(b.shape)
        assert (b.dtype == torch.bfloat16) == (np.asarray(a).dtype.name == "bfloat16")
        sa, sb = float(np.std(_np(jnp.asarray(a)))), float(b.float().std())
        assert abs(sa - sb) <= 0.05 * max(sa, 1e-6) or sa == sb == 0.0

    jax.tree.map(check, jp, jax.tree.map(lambda x: x, tp))


# ---------------------------------------------------------------------------
# CLIP vision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_vision_encode(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = jclip.tiny_clip_config()
    tcfg = tclip.tiny_clip_config()
    jp = jclip.init_clip_vision_params(jax.random.key(0), cfg, dtype=jdt)
    img = (np.random.default_rng(1).standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    want = jclip.clip_vision_encode(jp, cfg, jnp.asarray(img, jdt))
    got = tclip.clip_vision_encode(_to_torch(jp), tcfg, torch.from_numpy(img).to(tdt))
    assert got.shape == (2, cfg.num_tokens, cfg.width) and got.dtype == tdt
    ref = None
    if dtype == "bfloat16":
        ref = jclip.clip_vision_encode(jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                                       cfg, jnp.asarray(img))
    _check(got, want, dtype, ref)


def test_clip_image_encoder_class():
    cfg = tclip.tiny_clip_config()
    enc = tclip.CLIPImageEncoder(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    img = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 0.5
    tokens = enc(img)
    assert tokens.shape == (2, cfg.num_tokens, cfg.width)
    assert torch.isfinite(tokens).all()
    assert torch.equal(enc(img[0]), tokens[:1])  # a single image is batched
    assert tclip.CLIPVisionConfig().num_tokens == 257
    assert tclip.CLIPVisionConfig().width == 1280
    p = tclip.init_clip_vision_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(x.dtype == torch.float32 for x in p["blocks"]["qkv"].values())


# ---------------------------------------------------------------------------
# XLM-RoBERTa
# ---------------------------------------------------------------------------

def _xlm_ids():
    return np.array([[5, 9, 20, 33, 1, 1, 1, 1], [7, 2, 1, 1, 1, 1, 1, 1]], np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xlm_roberta_encode_and_clip_text(dtype):
    """float32 against the JAX functions; bf16 (which the JAX functions
    refuse: their float32 padding bias promotes the scan's bf16 carry)
    against the JAX float32 run on the same bf16-rounded weights."""
    jdt, tdt = DTYPES[dtype]
    cfg = jxlm.tiny_xlm_roberta_config()
    tcfg = txlm.tiny_xlm_roberta_config()
    jp = jxlm.init_xlm_roberta_params(jax.random.key(4), cfg, dtype=jdt)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = _to_torch(jp)
    ids = _xlm_ids()
    for jf, tf in ((jxlm.xlm_roberta_encode, txlm.xlm_roberta_encode),
                   (jxlm.xlm_roberta_clip_text, txlm.xlm_roberta_clip_text)):
        got = tf(tp, tcfg, torch.from_numpy(ids).long())
        assert got.dtype == tdt
        _check(got, jf(jp32, cfg, jnp.asarray(ids)), dtype)


def test_xlm_roberta_pre_norm():
    import dataclasses
    cfg = dataclasses.replace(jxlm.tiny_xlm_roberta_config(), post_norm=False)
    jp = jxlm.init_xlm_roberta_params(jax.random.key(5), cfg)
    ids = _xlm_ids()
    want = jxlm.xlm_roberta_encode(jp, cfg, jnp.asarray(ids))
    got = txlm.xlm_roberta_encode(_to_torch(jp), txlm.XLMRobertaConfig(**vars(cfg)),
                                  torch.from_numpy(ids).long())
    _check(got, want, "float32")


def test_convert_xlm_roberta_state_dict():
    """A torch state dict through both converters: the same trees, the same
    CLIP text features."""
    cfg = jxlm.tiny_xlm_roberta_config()
    g = torch.Generator().manual_seed(5)
    sd = {}

    def mk_lin(name, i, o, bias=True):
        sd[f"{name}.weight"] = torch.randn(o, i, generator=g) * 0.05
        if bias:
            sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.02

    for n, rows in (("token", cfg.vocab_size), ("type", cfg.type_size),
                    ("pos", cfg.max_seq_len)):
        sd[f"{n}_embedding.weight"] = torch.randn(rows, cfg.dim, generator=g) * 0.1
    sd["norm.weight"] = torch.randn(cfg.dim, generator=g) * 0.1 + 1
    sd["norm.bias"] = torch.randn(cfg.dim, generator=g) * 0.02
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for n in ("q", "k", "v", "o"):
            mk_lin(f"{pre}.attn.{n}", cfg.dim, cfg.dim)
        for n in ("norm1", "norm2"):
            sd[f"{pre}.{n}.weight"] = torch.randn(cfg.dim, generator=g) * 0.1 + 1
            sd[f"{pre}.{n}.bias"] = torch.randn(cfg.dim, generator=g) * 0.02
        mk_lin(f"{pre}.ffn.0", cfg.dim, cfg.dim * 4)
        mk_lin(f"{pre}.ffn.2", cfg.dim * 4, cfg.dim)
    mid = (cfg.dim + cfg.out_dim) // 2
    mk_lin("head.0", cfg.dim, mid, bias=False)
    mk_lin("head.2", mid, cfg.out_dim, bias=False)

    tcfg = txlm.tiny_xlm_roberta_config()
    jp = jxlm.convert_xlm_roberta_state_dict(sd, cfg)
    tp = txlm.convert_xlm_roberta_state_dict(sd, tcfg, device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_np(b), np.asarray(a)), jp,
                 jax.tree.map(lambda x: x, tp))
    ids = _xlm_ids()
    _check(txlm.xlm_roberta_clip_text(tp, tcfg, torch.from_numpy(ids).long()),
           jxlm.xlm_roberta_clip_text(jp, cfg, jnp.asarray(ids)), "float32")
