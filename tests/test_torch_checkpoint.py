"""The port's weights from files (`inferix_tpu_torch.utils.checkpoint`,
`native_checkpoint`, `state_checkpoint`) against the JAX package's loaders,
on files this test writes under tmp_path with the reference's key names and
shapes (`tests/test_checkpoint_and_text.py:_torch_causal_wan_sd`,
`tests/test_checkpoint_files.py:_torch_vae_sd`), values from seeds.

Tolerances: every converted leaf is held to the JAX converter's in path,
shape, dtype and value bit for bit; the safetensors reader to the
`safetensors` package bit for bit; native and state checkpoints round-trip
bit for bit, and a resumed stream equals the stream without the break.
The pipeline loaded from a file is held to tests/test_torch_pipeline.py's
TOL (latents 1e-4) and DECODE_TOL (pixels 1e-4), with the JAX draws put into
the port's `_draw_noise`; W8A8 from the same file to 1e-3 in norm (the JAX
side in its fused act-quant chain, interpreted). The VAE from a `.pth`
decodes within DECODE_TOL of JAX's.
"""
import contextlib
import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from inferix_tpu.core import config as jconfig
from inferix_tpu.core import types as jtypes
from inferix_tpu.kvcache.cache import KVCache as JaxKVCache
from inferix_tpu.models.text.umt5 import \
    convert_t5_encoder_state_dict as jax_convert_t5
from inferix_tpu.models.text.umt5 import tiny_umt5_config as jax_tiny_umt5
from inferix_tpu.models.wan.vae import CausalVAE as JaxVAE
from inferix_tpu.models.wan.vae import VAEConfig as JaxVAEConfig
from inferix_tpu.pipeline.self_forcing import SelfForcingPipeline as JaxPipeline
from inferix_tpu.pipeline.semi_ar import SemiARGenerator as JaxGenerator
from inferix_tpu.quant import api as japi
from inferix_tpu.utils import checkpoint as jckpt
from inferix_tpu.utils import state_checkpoint as jstate
from inferix_tpu_torch.core import config as tconfig
from inferix_tpu_torch.core import types as ttypes
from inferix_tpu_torch.kvcache.cache import KVCache
from inferix_tpu_torch.models.text.umt5 import UMT5Config
from inferix_tpu_torch.models.text.umt5 import \
    convert_t5_encoder_state_dict as port_convert_t5
from inferix_tpu_torch.models.wan.vae import CausalVAE as PortVAE
from inferix_tpu_torch.models.wan.vae import VAEConfig as PortVAEConfig
from inferix_tpu_torch.pipeline.self_forcing import SelfForcingPipeline as PortPipeline
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.quant.api import quantize_params
from inferix_tpu_torch.quant.kernels import quantize_weight_fp8
from inferix_tpu_torch.utils import checkpoint as tckpt
from inferix_tpu_torch.utils import native_checkpoint as tnative
from inferix_tpu_torch.utils import state_checkpoint as tstate
from inferix_tpu_torch.utils.params import init_params, params_from_numpy

from test_checkpoint_and_text import _torch_causal_wan_sd
from test_checkpoint_files import _torch_vae_sd
from test_torch_pipeline import VAE, _features, _jax_draws

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
W8A8_NORM_TOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_CFG = dict(dim=16, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
               temperal_downsample=(True,))


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _values(x) -> np.ndarray:
    """A leaf's values as float32 (exact for bf16 and e4m3) or its ints."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or "float" in a.dtype.name else a


def _assert_tree_equal(port, ref, path=""):
    """The port's tree against a JAX (or numpy) tree: the same paths, and
    every leaf of the same shape, dtype and value."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_tree_equal(p, r, f"{path}/{i}")
    else:
        assert tuple(port.shape) == tuple(np.shape(ref)), path
        assert _dtype_name(port) == str(np.asarray(ref).dtype), (path, port.dtype, ref.dtype)
        np.testing.assert_array_equal(_values(port), _values(ref), err_msg=path)


def _assert_port_trees_equal(a, b):
    leaves = zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in leaves:
        assert x.dtype == y.dtype and x.shape == y.shape and x.stride() == y.stride()
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x,
                           y.view(torch.uint8) if y.dtype == torch.float8_e4m3fn else y)


# ---------------------------------------------------------------------------
# the DiT: converter and file paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_causal_wan_state_dict(dtype):
    cfg = tconfig.tiny_test_config().model
    sd = _torch_causal_wan_sd(cfg)
    want = jckpt.convert_causal_wan_state_dict(sd, cfg, dtype=getattr(jnp, dtype))
    got = tckpt.convert_causal_wan_state_dict(sd, cfg, dtype=getattr(torch, dtype),
                                              device="cpu")
    _assert_tree_equal(got, want)
    # the JAX loader's policy: under bf16, float32 for the time embedding,
    # the modulation and every one-axis leaf
    if dtype == "bfloat16":
        assert got["patch_embedding"]["b"].dtype == torch.float32
        assert got["blocks"]["norm3"]["w"].dtype == torch.bfloat16


def test_convert_causal_wan_from_bf16_state_dict():
    """A bf16 checkpoint converts to the same tree as JAX's (the widening
    to float32 first changes no value)."""
    cfg = tconfig.tiny_test_config().model
    sd = {k: v.to(torch.bfloat16) for k, v in _torch_causal_wan_sd(cfg, seed=3).items()}
    for dt in ("float32", "bfloat16"):
        _assert_tree_equal(
            tckpt.convert_causal_wan_state_dict(sd, cfg, getattr(torch, dt), "cpu"),
            jckpt.convert_causal_wan_state_dict(sd, cfg, dtype=getattr(jnp, dt)))


def test_convert_causal_wan_missing_key():
    cfg = tconfig.tiny_test_config().model
    sd = _torch_causal_wan_sd(cfg)
    del sd["blocks.1.ffn.2.bias"]
    with pytest.raises(KeyError):
        tckpt.convert_causal_wan_state_dict(sd, cfg, device="cpu")


def test_self_forcing_checkpoint_files(tmp_path):
    """A directory holding a generator_ema .pt, and a bare .pth file: the
    same tree as the JAX loader's on the same file."""
    cfg = tconfig.tiny_test_config().model
    sd = _torch_causal_wan_sd(cfg, seed=1)
    (tmp_path / "dir").mkdir()
    torch.save({"generator_ema": sd, "step": 7}, tmp_path / "dir" / "b_ckpt.pt")
    torch.save({"generator_ema": {}}, tmp_path / "dir" / "z_other.pt")
    torch.save(sd, tmp_path / "model.pth")
    for path in (tmp_path / "dir", tmp_path / "model.pth"):
        for dt in ("float32", "bfloat16"):
            got = tckpt.load_self_forcing_checkpoint(str(path), cfg, getattr(torch, dt), "cpu")
            want = jckpt.load_self_forcing_checkpoint(str(path), cfg, dtype=getattr(jnp, dt))
            _assert_tree_equal(got, want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tckpt.load_self_forcing_checkpoint(str(tmp_path / "empty"), cfg, device="cpu")


@pytest.mark.parametrize("key", ["generator_ema", "generator", "model", "state_dict", None])
def test_load_torch_state_dict_unwraps(tmp_path, key):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "a.bias": torch.ones(2)}
    torch.save(sd if key is None else {key: sd, "other": 1}, tmp_path / "x.pt")
    got = tckpt.load_torch_state_dict(str(tmp_path / "x.pt"))
    want = jckpt.load_torch_state_dict(str(tmp_path / "x.pt"))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]) and torch.equal(want[k], sd[k])


# ---------------------------------------------------------------------------
# the pipeline with model_path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _jax_fused():
    """The JAX package's fused act-quant, in interpret mode, for one call."""
    japi.set_fused_act_quant(True, interpret=True)
    try:
        yield
    finally:
        japi.set_fused_act_quant(False)


def _pipes_from(path, quant: bool):
    jcfg, tcfg = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    for c in (jcfg, tcfg):
        c.model_path = str(path)
        c.runtime.num_frames = 4
        c.quant.enabled = quant
    jcfg.quant.fused_act_quant = True
    m = jcfg.model
    jvae = JaxVAE(JaxVAEConfig(**VAE), key=jax.random.key(9))
    jpipe = JaxPipeline(jcfg, vae=jvae, dtype=jnp.float32,
                        text_encoder=lambda p: jnp.asarray(_features(p, m.text_len, m.text_dim)))
    tpipe = PortPipeline(
        tcfg, vae=PortVAE(PortVAEConfig(**VAE),
                          params_from_numpy(jax.tree.map(np.asarray, jvae.params), "cpu",
                                            torch.float32), dtype=torch.float32, device="cpu"),
        text_encoder=lambda p: torch.from_numpy(_features(p, m.text_len, m.text_dim)),
        dtype=torch.float32, device="cpu")
    tpipe._draw_noise = _jax_draws(tpipe)
    jpipe.setup()
    tpipe.setup()
    return jpipe, tpipe


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("self_forcing")
    sd = _torch_causal_wan_sd(tconfig.tiny_test_config().model, seed=5)
    torch.save({"generator_ema": sd}, path / "self_forcing_dmd.pt")
    return path


def test_pipeline_model_path(checkpoint_dir):
    """SelfForcingPipeline(model_path=dir) against the JAX pipeline on the
    same directory: the loaded trees, NO_DECODE latents and AFTER_ALL
    latents and pixels."""
    jpipe, tpipe = _pipes_from(checkpoint_dir, quant=False)
    _assert_tree_equal(tpipe._params, jpipe._params)
    want = jpipe.run_text_to_video(["a cat"], decode_mode=jtypes.DecodeMode.NO_DECODE)
    got = tpipe.run_text_to_video(["a cat"], decode_mode=ttypes.DecodeMode.NO_DECODE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jvid, jlat = jpipe.run_text_to_video(["a dog"], seed=7, return_latents=True,
                                         decode_mode=jtypes.DecodeMode.AFTER_ALL)
    tvid, tlat = tpipe.run_text_to_video(["a dog"], seed=7, return_latents=True,
                                         decode_mode=ttypes.DecodeMode.AFTER_ALL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    assert tvid.shape == (1, 13, 32, 32, 3)
    np.testing.assert_allclose(tvid.numpy(), np.asarray(jvid), **DECODE_TOL)


def test_pipeline_model_path_w8a8(checkpoint_dir):
    """The same file under W8A8: quantize_params runs on the loaded tree
    (int8 codes equal to JAX's), and the latents agree to 1e-3 in norm."""
    jpipe, tpipe = _pipes_from(checkpoint_dir, quant=True)
    jq = jpipe._params["blocks"]["ffn"]["fc1"]
    tq = tpipe._params["blocks"]["ffn"]["fc1"]
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    with _jax_fused():
        want = np.asarray(jpipe.run_text_to_video(
            ["a cat"], decode_mode=jtypes.DecodeMode.NO_DECODE))
    got = tpipe.run_text_to_video(["a cat"], decode_mode=ttypes.DecodeMode.NO_DECODE).numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"W8A8 from a file: latents rel err {err:.3e}")
    assert err <= W8A8_NORM_TOL


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------

def test_convert_wan_vae_state_dict():
    sd = _torch_vae_sd(JaxVAEConfig(**VAE_CFG))
    want = jckpt.convert_wan_vae_state_dict(sd, JaxVAEConfig(**VAE_CFG))
    got = tckpt.convert_wan_vae_state_dict(sd, PortVAEConfig(**VAE_CFG), device="cpu")
    _assert_tree_equal(got, want)


def test_convert_wan_vae_missing_key():
    sd = _torch_vae_sd(JaxVAEConfig(**VAE_CFG))
    del sd["decoder.head.2.weight"]
    with pytest.raises(KeyError):
        tckpt.convert_wan_vae_state_dict(sd, PortVAEConfig(**VAE_CFG), device="cpu")


def test_wan_vae_pth_decodes(tmp_path):
    torch.save(_torch_vae_sd(JaxVAEConfig(**VAE_CFG)), tmp_path / "Wan2.1_VAE.pth")
    jvae = jckpt.load_wan_vae(str(tmp_path / "Wan2.1_VAE.pth"), JaxVAEConfig(**VAE_CFG))
    tvae = tckpt.load_wan_vae(str(tmp_path / "Wan2.1_VAE.pth"), PortVAEConfig(**VAE_CFG),
                              device="cpu")
    z = np.random.default_rng(2).standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jvae.decode(jnp.asarray(z)))
    got = tvae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == (1, 5, 8, 8, 3)
    np.testing.assert_allclose(got, want, **DECODE_TOL)


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def test_safetensors_float32_shards_against_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    tensors = {f"layer.{i}.weight": rng.standard_normal((3 + i, 5)).astype(np.float32)
               for i in range(6)}
    tensors["scalar"] = np.array(2.5, np.float32)
    tensors["empty"] = np.zeros((0, 4), np.float32)
    keys = sorted(tensors)
    save_file({k: tensors[k] for k in keys[:4]}, tmp_path / "m-00001-of-00002.safetensors")
    save_file({k: tensors[k] for k in keys[4:]}, tmp_path / "m-00002-of-00002.safetensors",
              metadata={"format": "pt"})
    got = tckpt.load_sharded_safetensors(str(tmp_path))
    assert sorted(got) == keys
    for name in ("m-00001-of-00002", "m-00002-of-00002"):
        with safe_open(str(tmp_path / f"{name}.safetensors"), framework="np") as f:
            for k in f.keys():
                want = f.get_tensor(k)
                assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want.shape
                np.testing.assert_array_equal(got[k].numpy(), want)


def test_safetensors_dtypes_bit_equal(tmp_path):
    """bf16, f16, int8, uint8, int32, int64 and e4m3 tensors written by
    `safetensors.torch`: the reader's bits equal `load_file`'s."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(1)
    x = torch.randn(7, 33, generator=g) * 40
    tensors = {
        "bf16": x.to(torch.bfloat16), "f16": x.to(torch.float16),
        "i8": torch.randint(-128, 128, (5, 9), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (4, 3), generator=g, dtype=torch.uint8),
        "i32": torch.randint(-2**31, 2**31 - 1, (6,), generator=g, dtype=torch.int32),
        "i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4) * 2**40,
        # every e4m3 byte, NaNs included
        "f8": torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn),
    }
    save_file(tensors, str(tmp_path / "t.safetensors"))
    want = load_file(str(tmp_path / "t.safetensors"))
    got = tckpt.read_safetensors(str(tmp_path / "t.safetensors"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        bits = (lambda t: t.view(torch.uint8)) if w.element_size() == 1 else (lambda t: t)
        if w.dtype in (torch.bfloat16, torch.float16):
            bits = (lambda t: t.view(torch.int16))
        assert torch.equal(bits(got[k]), bits(w)), k


def _write_header(path, header: dict, data: bytes):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + data)


def test_safetensors_refuses_unknown_dtypes(tmp_path):
    from safetensors.numpy import save_file

    save_file({"x": np.ones(3, np.float64)}, tmp_path / "f64.safetensors")
    with pytest.raises(ValueError, match="'F64'"):
        tckpt.read_safetensors(str(tmp_path / "f64.safetensors"))
    _write_header(tmp_path / "odd.safetensors",
                  {"y": {"dtype": "Q4", "shape": [2], "data_offsets": [0, 1]}}, b"\0")
    with pytest.raises(ValueError, match="'Q4'"):
        tckpt.read_safetensors(str(tmp_path / "odd.safetensors"))
    _write_header(tmp_path / "short.safetensors",
                  {"z": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
    with pytest.raises(ValueError, match="offsets"):
        tckpt.read_safetensors(str(tmp_path / "short.safetensors"))


def _hf_umt5_state_dict(cfg, seed=4):
    """A UMT5 encoder state dict in HF `UMT5EncoderModel` key names."""
    g = torch.Generator().manual_seed(seed)
    d, inner, ff = cfg.dim, cfg.dim_attn, cfg.dim_ffn

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(torch.bfloat16)

    sd = {"shared.weight": w(cfg.vocab_size, d), "encoder.final_layer_norm.weight": w(d)}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        att = f"{pre}.layer.0.SelfAttention"
        sd[f"{pre}.layer.0.layer_norm.weight"] = w(d)
        sd[f"{pre}.layer.1.layer_norm.weight"] = w(d)
        for n in ("q", "k", "v"):
            sd[f"{att}.{n}.weight"] = w(inner, d)
        sd[f"{att}.o.weight"] = w(d, inner)
        sd[f"{att}.relative_attention_bias.weight"] = w(cfg.num_buckets, cfg.num_heads)
        sd[f"{pre}.layer.1.DenseReluDense.wi_0.weight"] = w(ff, d)
        sd[f"{pre}.layer.1.DenseReluDense.wi_1.weight"] = w(ff, d)
        sd[f"{pre}.layer.1.DenseReluDense.wo.weight"] = w(d, ff)
    return sd


def test_sharded_umt5_directory(tmp_path):
    """A 3-shard UMT5 directory in HF key names, bf16 on disk: the port's
    reader and converter give the JAX reader's and converter's tree."""
    from safetensors.torch import save_file

    jcfg = jax_tiny_umt5()
    tcfg = UMT5Config(**dataclasses.asdict(jcfg))
    sd = _hf_umt5_state_dict(jcfg)
    keys = sorted(sd)
    for i, part in enumerate(np.array_split(np.arange(len(keys)), 3)):
        save_file({keys[j]: sd[keys[j]] for j in part},
                  str(tmp_path / f"model-{i + 1:05d}-of-00003.safetensors"))
    got_sd = tckpt.load_sharded_safetensors(str(tmp_path))
    assert sorted(got_sd) == keys
    for k in keys:
        assert torch.equal(got_sd[k].view(torch.int16), sd[k].view(torch.int16)), k
    want = jax_convert_t5({k: v.float().numpy() for k, v in sd.items()}, jcfg)
    got = port_convert_t5(got_sd, tcfg, device="cpu")
    _assert_tree_equal(got, want)


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_tree():
    cfg = tconfig.tiny_test_config().model
    return init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["float", "w8a8", "fp8"])
def test_native_checkpoint_round_trip(tmp_path, float_tree, kind):
    tree = float_tree
    if kind != "float":
        qc = tconfig.QuantConfig(enabled=True, dtype="int8" if kind == "w8a8" else "fp8")
        tree = quantize_params(tree, qc)
        leaf = tree["blocks"]["ffn"]["fc1"]
        assert leaf["w_q"].dtype == (torch.int8 if kind == "w8a8" else torch.float8_e4m3fn)
        assert leaf["scale"].dtype == torch.float32
    path = tnative.save_params(str(tmp_path / "ckpt"), tree)
    _assert_port_trees_equal(tnative.load_params(path, device="cpu"), tree)


def test_native_checkpoint_target_restores_dtypes(tmp_path, float_tree):
    path = tnative.save_params(str(tmp_path / "ckpt"), float_tree)
    target = jax.tree_util.tree_map(lambda x: x.float(), float_tree)
    got = tnative.load_params(path, target=target)
    _assert_port_trees_equal(got, target)
    w, _ = quantize_weight_fp8(torch.randn(8, 16, generator=torch.Generator().manual_seed(0)))
    tnative.save_params(str(tmp_path / "fp8"), {"w": w})
    back = tnative.load_params(str(tmp_path / "fp8"), target={"w": w})["w"]
    assert back.dtype == torch.float8_e4m3fn
    assert torch.equal(back.view(torch.uint8), w.view(torch.uint8))


# ---------------------------------------------------------------------------
# state checkpoints
# ---------------------------------------------------------------------------

def test_state_round_trip_types(tmp_path):
    g = torch.Generator().manual_seed(7)
    path = tstate.save_generation_state(
        str(tmp_path / "state.npz"),
        cache={"k": torch.ones(2, 3, dtype=torch.bfloat16), "scale": None},
        generator=g, frames_done=5, latents=torch.zeros(1, 2, 4),
        kv=KVCache(k=torch.full((2,), 3, dtype=torch.int8), v=torch.ones(2, dtype=torch.int8)))
    st = tstate.load_generation_state(path, device="cpu")
    assert st["cache"]["k"].dtype == torch.bfloat16 and st["cache"]["scale"] is None
    assert st["frames_done"] == 5
    assert st["kv"]["k"].dtype == torch.int8 and st["kv"]["k_scale"] is None
    assert torch.equal(torch.randn(4, generator=st["generator"]), torch.randn(4, generator=g))


def test_state_fp8_round_trip(tmp_path):
    vals = torch.tensor([0.5, -1.25, 448.0, 0.001, -0.0])
    cache_k = vals.repeat(4, 5).to(torch.float8_e4m3fn)
    path = tstate.save_generation_state(str(tmp_path / "s.npz"), cache_k=cache_k)
    back = tstate.load_generation_state(path, device="cpu")["cache_k"]
    assert back.dtype == torch.float8_e4m3fn
    assert torch.equal(back.view(torch.uint8), cache_k.view(torch.uint8))


def test_state_npz_read_by_the_other_package(tmp_path):
    """Arrays saved by either package read back equal in the other (bf16,
    e4m3, int8, float32, None and scalars)."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 4)).astype(np.float32)
    codes = rng.integers(-127, 128, (2, 3), dtype=np.int8)
    jpath = jstate.save_generation_state(
        str(tmp_path / "jax.npz"),
        cache={"k": jnp.asarray(k, jnp.bfloat16), "codes": jnp.asarray(codes), "s": None},
        fp8=jnp.asarray(k, jnp.float8_e4m3fn), frames_done=3, rng=jax.random.key(1))
    st = tstate.load_generation_state(jpath, device="cpu")
    assert st["cache"]["k"].dtype == torch.bfloat16 and st["cache"]["s"] is None
    np.testing.assert_array_equal(st["cache"]["k"].float().numpy(),
                                  k.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(st["cache"]["codes"].numpy(), codes)
    np.testing.assert_array_equal(st["fp8"].float().numpy(),
                                  k.astype(ml_dtypes.float8_e4m3fn).astype(np.float32))
    assert st["frames_done"] == 3
    np.testing.assert_array_equal(st["rng"].numpy(), np.asarray(jax.random.key_data(jax.random.key(1))))

    tpath = tstate.save_generation_state(
        str(tmp_path / "port.npz"),
        cache={"k": torch.from_numpy(k).to(torch.bfloat16), "codes": torch.from_numpy(codes),
               "s": None},
        fp8=torch.from_numpy(k).to(torch.float8_e4m3fn), frames_done=3,
        generator=torch.Generator().manual_seed(2))
    jst = jstate.load_generation_state(tpath)
    assert jst["cache"]["k"].dtype == jnp.bfloat16 and jst["cache"]["s"] is None
    np.testing.assert_array_equal(np.asarray(jst["cache"]["k"], np.float32),
                                  st["cache"]["k"].float().numpy())
    np.testing.assert_array_equal(np.asarray(jst["cache"]["codes"]), codes)
    assert jst["fp8"].dtype == jnp.float8_e4m3fn
    np.testing.assert_array_equal(np.asarray(jst["fp8"], np.float32), st["fp8"].float().numpy())
    assert jst["frames_done"] == 3


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_resume_continues_bitwise(tmp_path, quantized):
    """tests/test_state_checkpoint.py:35 on the port: 2 blocks, a snapshot
    of the cache, the generator and frames_done, a resume from the file and
    2 more blocks equal the 4 blocks without the break; the int8 cache too."""
    cfg = tconfig.tiny_test_config()
    cfg.quant.enabled = cfg.quant.quantize_kv_cache = quantized
    params = init_params(cfg.model, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    gen = SemiARGenerator(cfg, params, dtype=torch.float32, device="cpu")
    xattn = gen.encode_text_context(torch.zeros(1, cfg.model.text_len, cfg.model.text_dim))
    r = cfg.runtime
    noise = torch.randn(1, 4, r.latent_height, r.latent_width, r.latent_channels,
                        generator=torch.Generator().manual_seed(1))
    full, _ = gen.generate(noise, xattn, generator=torch.Generator().manual_seed(2))

    cache, g = gen.init_cache(), torch.Generator().manual_seed(2)
    outs = []
    for bi in range(2):
        x0, cache = gen.denoise_block(cache, xattn, noise[:, bi:bi + 1], bi, generator=g)
        outs.append(x0)
    path = tstate.save_generation_state(str(tmp_path / "mid.npz"), cache=cache,
                                        generator=g, frames_done=2)
    del cache, g
    st = tstate.load_generation_state(path, device="cpu")
    cache2 = KVCache(**st["cache"])
    assert (cache2.k.dtype == torch.int8) == quantized
    g2 = st["generator"]
    for bi in range(st["frames_done"], 4):
        x0, cache2 = gen.denoise_block(cache2, xattn, noise[:, bi:bi + 1], bi, generator=g2)
        outs.append(x0)
    assert torch.equal(torch.cat(outs, dim=1), full)


def test_jax_cache_snapshot_resumes_in_the_port(tmp_path):
    """A JAX generator's float32 cache after 2 blocks, saved by the JAX
    package and read by the port, is the cache the port's generator builds
    from the same parameters and draws (TOL)."""
    jcfg, tcfg = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    from inferix_tpu.models.wan.causal_dit import init_params as jax_init_params

    jp = jax_init_params(jax.random.key(0), jcfg.model, dtype=jnp.float32)
    jgen = JaxGenerator(jcfg, jp, dtype=jnp.float32)
    tgen = SemiARGenerator(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                   torch.float32),
                           dtype=torch.float32, device="cpu")
    ctx = np.zeros((1, jcfg.model.text_len, jcfg.model.text_dim), np.float32)
    jx, tx = jgen.encode_text_context(jnp.asarray(ctx)), tgen.encode_text_context(
        torch.from_numpy(ctx))
    r = jcfg.runtime
    noise = np.random.default_rng(3).standard_normal(
        (1, 2, r.latent_height, r.latent_width, r.latent_channels)).astype(np.float32)
    jcache, rng = jgen.init_cache(), jax.random.key(2)
    tcache = tgen.init_cache()
    n_steps = len(jcfg.runtime.denoising_step_list)
    for bi in range(2):
        rng, sub = jax.random.split(rng)
        _, jcache = jgen.denoise_block(jcache, jx, jnp.asarray(noise[:, bi:bi + 1]), sub, bi)
        keys = jax.random.split(sub, n_steps)
        renoise = [torch.from_numpy(np.array(jax.random.normal(
            keys[i], noise[:, :1].shape, jnp.float32))) for i in range(n_steps - 1)]
        tgen.denoise_block(tcache, tx, torch.from_numpy(noise[:, bi:bi + 1]), bi,
                           renoise=renoise)
    path = jstate.save_generation_state(str(tmp_path / "jax.npz"), cache=jcache)
    st = tstate.load_generation_state(path, device="cpu")
    assert isinstance(jcache, JaxKVCache)
    for name in ("k", "v"):
        np.testing.assert_allclose(st["cache"][name].numpy(), getattr(tcache, name).numpy(),
                                   **TOL)


def test_files_read_without_optional_packages(tmp_path):
    """In an interpreter where safetensors, imageio and orbax cannot be
    imported (as on the card's machine), every module of the port imports,
    the reader reads a sharded directory and save_video writes an .npz;
    none of those packages was loaded."""
    from safetensors.torch import save_file

    save_file({"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
              str(tmp_path / "m-1.safetensors"))
    save_file({"b": torch.ones(2, dtype=torch.bfloat16)}, str(tmp_path / "m-2.safetensors"))
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('safetensors', 'imageio', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "import inferix_tpu_torch\n"
        "for m in pkgutil.walk_packages(inferix_tpu_torch.__path__, 'inferix_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from inferix_tpu_torch.utils.checkpoint import load_sharded_safetensors\n"
        "from inferix_tpu_torch.core.media.video_utils import save_video\n"
        f"sd = load_sharded_safetensors({str(tmp_path)!r})\n"
        "assert sd['a'].tolist() == [[0, 1, 2], [3, 4, 5]], sd\n"
        "assert str(sd['b'].dtype) == 'torch.bfloat16'\n"
        f"out = save_video(np.zeros((2, 4, 4, 3), np.uint8), {str(tmp_path / 'v.mp4')!r})\n"
        "assert out.endswith('v.npz'), out\n"
        "loaded = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('safetensors', 'imageio', 'orbax', 'jax', 'inferix_tpu') and sys.modules[n])\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---------------------------------------------------------------------------
# the MAGI DiT: converter over .pt and safetensors files
# ---------------------------------------------------------------------------

def _magi_reference_sd(layout: str):
    """A reference-format MAGI state dict (tests/test_magi_torch_parity.py's
    key names and shapes): every float tensor bf16 ("bf16"), or the fp8
    distill layout with its middle layer e4m3 and its scales float32."""
    from inferix_tpu.models.magi.dit import tiny_magi_config
    from test_magi_torch_parity import make_reference_sd

    cfg = dataclasses.replace(tiny_magi_config(), num_layers=3)
    sd = make_reference_sd(cfg, fp8_layers=(1,) if layout == "fp8" else ())
    out = {}
    for k, v in sd.items():
        if v.dtype == torch.float32 and not k.endswith(("_scale", "input_scale")):
            v = v.to(torch.bfloat16)
        out[k] = v.contiguous().clone()
    return cfg, out


@pytest.mark.parametrize("layout", ["bf16", "fp8"])
@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_magi_state_dict_files(tmp_path, layout, fmt, dtype):
    """A reference MAGI state dict written to a `.pt` file or a safetensors
    shard and read by the port's readers: `convert_magi_state_dict` gives
    the JAX converter's tree (on the same dict) leaf for leaf in path,
    shape, dtype and value: `blocks` stacked, or the fp8 layout's
    `blocks_first` / stacked `blocks_mid` / `blocks_last`."""
    from safetensors.torch import save_file

    from inferix_tpu_torch.models.magi.dit import MagiModelConfig

    jcfg, sd = _magi_reference_sd(layout)
    if fmt == "pt":
        torch.save(sd, tmp_path / "dit.pt")
        read = tckpt.load_torch_state_dict(str(tmp_path / "dit.pt"))
    else:
        save_file(sd, str(tmp_path / "model-00001-of-00001.safetensors"))
        read = tckpt.load_sharded_safetensors(str(tmp_path))
    assert sorted(read) == sorted(sd)
    got = tckpt.convert_magi_state_dict(read, MagiModelConfig(**dataclasses.asdict(jcfg)),
                                        getattr(torch, dtype), "cpu")
    want = jckpt.convert_magi_state_dict(sd, jcfg, dtype=getattr(jnp, dtype))
    _assert_tree_equal(got, want)
    if layout == "fp8":
        assert got["blocks_mid"]["q"]["w_q"].dtype == torch.float8_e4m3fn
        assert got["blocks_mid"]["proj"]["smooth_scale"].shape == (1, 256)
        assert "blocks" not in got
    else:
        assert got["blocks"]["q"]["w"].shape == (3, 128, 128)


def test_convert_magi_state_dict_values_as_float32():
    """e4m3 weights handed over as float32 values of their codes (how a
    numpy path carries them) convert to the same e4m3 bits."""
    jcfg, sd = _magi_reference_sd("fp8")
    from inferix_tpu_torch.models.magi.dit import MagiModelConfig

    cfg = MagiModelConfig(**dataclasses.asdict(jcfg))
    widened = {k: (v.float() if v.dtype == torch.float8_e4m3fn else v) for k, v in sd.items()}
    a = tckpt.convert_magi_state_dict(sd, cfg, torch.float32, "cpu")
    b = tckpt.convert_magi_state_dict(widened, cfg, torch.float32, "cpu")
    _assert_port_trees_equal(a, b)
    del sd["videodit_blocks.layers.2.mlp.linear_fc2.weight"]
    with pytest.raises(KeyError):
        tckpt.convert_magi_state_dict(sd, cfg, device="cpu")
