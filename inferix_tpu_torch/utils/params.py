"""Model parameters for the port: carried across from the JAX package's tree,
or drawn from a seed.

The tree is the JAX package's own layout (`causal_dit.py:init_params`,
`vae.py:init_encoder`, `init_decoder`): nested dicts (and, in the VAE, the
lists `downsamples` and `upsamples`) whose transformer-block leaves are stacked on a leading [L]
axis, linear weights stored [in, out], conv weights [kt, kh, kw, in, out].
The port keeps that layout, so a layer is a view `leaf[l]` and a checkpoint
converted for one package fits both.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device

Params = Dict[str, Any]

# Keys the JAX package keeps in float32 whatever the model dtype: the time
# embedding MLP, its projection to the six modulation vectors, the
# modulation tables, and the scales of quantized linears ({"w_q", "scale",
# "b"}: a bf16 scale would move every output of the int8 GEMM).
_FP32_KEYS = ("time_embedding", "time_projection", "modulation", "scale")


def params_from_numpy(tree: Params, device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Params:
    """Turn the JAX parameter tree (nested dicts of numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`) into the port's tree of tensors on
    `device`. Floating leaves become `dtype`, except the float32 keys
    above; integer leaves (int8 `w_q`) keep their type, and e4m3 leaves
    (fp8 `w_q`, ml_dtypes' float8_e4m3fn from JAX) become
    torch.float8_e4m3fn through a uint8 view, so their bits are carried, not
    re-rounded. Works for stacked layers, for unfused or fused (`qkv`)
    self-attention projections, for float, int8- or fp8-quantized trees
    alike, and for the VAE's tree (lists are walked like dicts)."""
    dev = resolve_device(device)

    def convert(node, fp32: bool):
        if isinstance(node, dict):
            return {k: convert(v, fp32 or k in _FP32_KEYS) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, fp32) for v in node]
        arr = np.asarray(node)
        if arr.dtype.name == "float8_e4m3fn":
            t = torch.from_numpy(np.array(arr.view(np.uint8)))
            return t.view(torch.float8_e4m3fn).to(dev)
        if arr.dtype.name.startswith("float8"):
            raise TypeError(f"only float8_e4m3fn leaves are ported, got {arr.dtype}")
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 from JAX
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if t.is_floating_point():
            t = t.to(torch.float32 if fp32 else dtype)
        return t.to(dev)

    return convert(tree, False)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random parameters from the same distributions as the JAX package's
    `init_params` (not the same bits): linear weights U(-1/sqrt(in),
    1/sqrt(in)) drawn in float32 and cast, zero biases, unit norm weights,
    modulation N(0, 1)/sqrt(dim) in float32. An i2v model (`model_type`
    "i2v") also gets `img_emb` (LayerNorm 1280, linear 1280 -> 1280, linear
    1280 -> dim, LayerNorm dim) and, in every block, `k_img`, `v_img` and
    `norm_k_img`. `generator` must live on `device`."""
    if cfg.model_type not in ("t2v", "i2v"):
        raise ValueError(f"model_type must be 't2v' or 'i2v', got {cfg.model_type!r}")
    dev = resolve_device(device)
    d = cfg.dim
    lin = _linear_init(generator, dev, dtype)
    patch = math.prod(cfg.patch_size)
    params = {
        "patch_embedding": lin(patch * cfg.in_dim, d),
        "text_embedding": {"fc1": lin(cfg.text_dim, d), "fc2": lin(d, d)},
        "time_embedding": {"fc1": lin(cfg.freq_dim, d, torch.float32),
                           "fc2": lin(d, d, torch.float32)},
        "time_projection": lin(d, 6 * d, torch.float32),
        "blocks": init_block_params(cfg, generator, cfg.num_layers, dev, dtype),
        "head": {"head": lin(d, patch * cfg.out_dim),
                 "modulation": torch.randn(2, d, generator=generator, dtype=torch.float32,
                                           device=dev) / math.sqrt(d)},
    }
    if cfg.model_type == "i2v":
        params["img_emb"] = {
            "norm1": {"w": torch.ones(1280, dtype=dtype, device=dev),
                      "b": torch.zeros(1280, dtype=dtype, device=dev)},
            "fc1": lin(1280, 1280), "fc2": lin(1280, d),
            "norm2": {"w": torch.ones(d, dtype=dtype, device=dev),
                      "b": torch.zeros(d, dtype=dtype, device=dev)}}
    return params


def _linear_init(generator: torch.Generator, dev: torch.device, dtype: torch.dtype):
    """linear(in, out, out_dtype, layers) -> {"w": U(-1/sqrt(in), 1/sqrt(in))
    [*layers, in, out], "b": zeros}."""
    def linear(in_dim, out_dim, out_dtype=dtype, layers=()):
        w = torch.empty((*layers, in_dim, out_dim), dtype=torch.float32, device=dev)
        bound = 1.0 / math.sqrt(in_dim)
        return {"w": w.uniform_(-bound, bound, generator=generator).to(out_dtype),
                "b": torch.zeros((*layers, out_dim), dtype=out_dtype, device=dev)}

    return linear


def init_block_params(cfg: ModelConfig, generator: torch.Generator, layers: int,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Params:
    """The transformer blocks of `init_params`, stacked on a leading
    [layers] axis (a caller can draw a deep model a few layers at a time)."""
    dev = resolve_device(device)
    d = cfg.dim
    L = (layers,)
    lin = _linear_init(generator, dev, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def attn(img: bool):
        p = {**{n: lin(d, d, layers=L) for n in ("q", "k", "v", "o")},
             "norm_q": {"w": ones(layers, d)}, "norm_k": {"w": ones(layers, d)}}
        if img:
            p.update(k_img=lin(d, d, layers=L), v_img=lin(d, d, layers=L),
                     norm_k_img={"w": ones(layers, d)})
        return p

    return {
        "self_attn": attn(False),
        "cross_attn": attn(cfg.model_type == "i2v"),
        "norm3": {"w": ones(layers, d),
                  "b": torch.zeros(layers, d, dtype=dtype, device=dev)},
        "ffn": {"fc1": lin(d, cfg.ffn_dim, layers=L),
                "fc2": lin(cfg.ffn_dim, d, layers=L)},
        "modulation": torch.randn(layers, 6, d, generator=generator, dtype=torch.float32,
                                  device=dev) / math.sqrt(d),
    }


def init_vae_params(cfg, generator: torch.Generator,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    """Random VAE parameters `{"encoder", "decoder", "conv1", "conv2"}` from
    the same distributions as the JAX package's `init_encoder`,
    `init_decoder` and the `CausalVAE` 1x1x1 convs (not the same bits): conv
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), RMS-norm gammas
    1, and the attention output projections zero (the reference's init).
    The decoder and conv2 are drawn first, then the encoder and conv1, so a
    generator seeded alike gives the decoder the bits it had before the
    encoder was drawn too. cfg: a `models.wan.vae.VAEConfig`; `generator`
    must live on `device`."""
    dev = resolve_device(device)

    def conv(kt, kh, kw, cin, cout):
        bound = 1.0 / math.sqrt(kt * kh * kw * cin)

        def u(*shape):
            w = torch.empty(shape, dtype=torch.float32, device=dev)
            return w.uniform_(-bound, bound, generator=generator).to(dtype)

        return {"w": u(kt, kh, kw, cin, cout), "b": u(cout)}

    def gamma(c):
        return {"gamma": torch.ones(c, dtype=dtype, device=dev)}

    def res(cin, cout):
        p = {"norm1": gamma(cin), "conv1": conv(3, 3, 3, cin, cout),
             "norm2": gamma(cout), "conv2": conv(3, 3, 3, cout, cout)}
        if cin != cout:
            p["shortcut"] = conv(1, 1, 1, cin, cout)
        return p

    def attn(c):
        return {"norm": gamma(c), "qkv": conv(1, 1, 1, c, 3 * c),
                "proj": {"w": torch.zeros(1, 1, 1, c, c, dtype=dtype, device=dev),
                         "b": torch.zeros(c, dtype=dtype, device=dev)}}

    def resample(c, mode):
        if mode.startswith("downsample"):
            p = {"conv": conv(1, 3, 3, c, c)}
            if mode == "downsample3d":
                p["time_conv"] = conv(3, 1, 1, c, c)
            return p
        p = {"conv": conv(1, 3, 3, c, c // 2)}
        if mode == "upsample3d":
            p["time_conv"] = conv(3, 1, 1, c, 2 * c)
        return p

    dims = [cfg.dim * u for u in (cfg.dim_mult[-1], *reversed(cfg.dim_mult))]
    dec: Params = {"conv1": conv(3, 3, 3, cfg.z_dim, dims[0]),
                   "middle": {"res1": res(dims[0], dims[0]), "attn": attn(dims[0]),
                              "res2": res(dims[0], dims[0])}}
    ups: List[Params] = []
    scale = 1.0 / 2 ** (len(cfg.dim_mult) - 2)
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2
        for _ in range(cfg.num_res_blocks + 1):
            ups.append({"res": res(cin, cout)})
            if scale in cfg.attn_scales:
                ups.append({"attn": attn(cout)})
            cin = cout
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            ups.append({f"resample:{mode}": resample(cout, mode)})
            scale *= 2.0
    dec["upsamples"] = ups
    dec["head_norm"] = gamma(cfg.dim)
    dec["head_conv"] = conv(3, 3, 3, cfg.dim, 3)
    conv2 = conv(1, 1, 1, cfg.z_dim, cfg.z_dim)

    dims = [cfg.dim * u for u in (1, *cfg.dim_mult)]
    enc: Params = {"conv1": conv(3, 3, 3, 3, dims[0])}
    downs: List[Params] = []
    scale = 1.0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            downs.append({"res": res(cin, cout)})
            if scale in cfg.attn_scales:
                downs.append({"attn": attn(cout)})
            cin = cout
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
            downs.append({f"resample:{mode}": resample(cout, mode)})
            scale /= 2.0
    enc["downsamples"] = downs
    enc["middle"] = {"res1": res(dims[-1], dims[-1]), "attn": attn(dims[-1]),
                     "res2": res(dims[-1], dims[-1])}
    enc["head_norm"] = gamma(dims[-1])
    enc["head_conv"] = conv(3, 3, 3, dims[-1], 2 * cfg.z_dim)
    conv1 = conv(1, 1, 1, 2 * cfg.z_dim, 2 * cfg.z_dim)
    return {"encoder": enc, "decoder": dec, "conv1": conv1, "conv2": conv2}
