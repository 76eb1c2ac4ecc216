"""Checkpoint loading: the reference's torch and safetensors files -> the
port's parameter trees (port of `inferix_tpu/utils/checkpoint.py`).

- `load_torch_state_dict`: a `.pt` / `.pth` file, memory-mapped, unwrapped
  from its `generator_ema` / `generator` / `model` / `state_dict` nest.
- `load_sharded_safetensors`: every `.safetensors` file of a directory,
  read by the port's own reader of the format (below), one thread a shard.
- `convert_causal_wan_state_dict` / `load_self_forcing_checkpoint`: the
  reference `CausalWanModel` state dict -> the causal-DiT tree
  (`utils/params.py`'s layout).
- `convert_wan_vae_state_dict` / `load_wan_vae`: `Wan2.1_VAE.pth` -> the
  port's `CausalVAE`.
- `convert_magi_state_dict` (`:334-451`): the reference MAGI `VideoDiTModel`
  state dict, bf16 or the fp8 distill-quant layout, -> the MAGI DiT tree.
- `vitvae_config_from_ddconfig` / `convert_magi_vae_state_dict` /
  `load_magi_vae` (`:452-569`): a MAGI ViT-VAE directory (`config.json` +
  safetensors or `.bin`) -> the port's `ViTVAE`.

Layouts converted: torch Linear [out, in] -> [in, out]; the patch Conv3d
[dim, in, pt, ph, pw] -> [(pt ph pw in), dim]; VAE convs
[out, in, kt, kh, kw] -> [kt, kh, kw, in, out], a Conv2d gaining kt = 1;
per-layer block leaves stacked on a leading [L] axis.

The dtype policy is the JAX loader's (`:166-205`): under a bf16 model every
leaf of two or more axes becomes bf16, except the time embedding, its
projection and the modulation tables, which stay float32, as does every
one-axis leaf (the patch, text and head biases). Each leaf is converted on
the host and copied to the device once, in its final dtype.

The safetensors format: an 8-byte little-endian header length N, N bytes of
JSON (`{name: {"dtype", "shape", "data_offsets": [begin, end]}}`, plus an
optional `__metadata__`), then the tensors' raw little-endian bytes, offsets
counted from the end of the header. The port reads it itself, so that it
needs no `safetensors` package; bf16 and e4m3 values are carried bit for
bit.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..core.memory import tree_map

Params = Dict[str, Any]

_SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
    "F8_E4M3": torch.float8_e4m3fn,
}
# The JAX loader's "ndim >= 2 -> bf16" exceptions: kept in float32.
_FP32_NAMES = ("time_", "modulation")


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a .pt/.pth file (memory-mapped, weights only, when it allows)
    and unwrap the first of `generator_ema`, `generator`, `model`,
    `state_dict` that holds a dict."""
    try:
        sd = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    except Exception:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("generator_ema", "generator", "model", "state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    return sd


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors of their own
    (the file is not kept open). Raises ValueError on a dtype the port does
    not read, naming it, and on a header whose offsets do not fit."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    if mm.size < 8:
        raise ValueError(f"{path}: not a safetensors file ({mm.size} bytes)")
    n = int(np.frombuffer(mm[:8].tobytes(), "<u8")[0])
    if 8 + n > mm.size:
        raise ValueError(f"{path}: header of {n} bytes past the end of the file")
    header = json.loads(mm[8:8 + n].tobytes())
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']!r}, "
                             f"which the reader does not take "
                             f"({', '.join(_SAFETENSORS_DTYPES)})")
        shape = tuple(meta["shape"])
        begin, end = meta["data_offsets"]
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if end - begin != nbytes or base + end > mm.size or begin < 0:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} "
                             f"for {nbytes} bytes in a file of {mm.size}")
        if nbytes == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.from_numpy(np.array(mm[base + begin:base + end]))
        out[name] = raw.view(dtype).reshape(shape)
    del mm
    return out


def load_sharded_safetensors(directory: str, max_workers: int = 8
                             ) -> Dict[str, torch.Tensor]:
    """Every tensor of a sharded-safetensors directory (its .safetensors
    files in sorted order), one thread a shard, as CPU tensors."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.endswith(".safetensors"))
    sd: Dict[str, torch.Tensor] = {}
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        for part in ex.map(read_safetensors, files):
            sd.update(part)
    return sd


def _host_dtype(name: str, ndim: int, dtype: torch.dtype) -> torch.dtype:
    """A converted leaf's dtype under the JAX loader's policy: float32 for
    the time embedding, its projection and the modulation; under bf16,
    bf16 for leaves of two or more axes and float32 for the rest; under any
    other dtype, that dtype."""
    if any(s in name for s in _FP32_NAMES):
        return torch.float32
    if dtype == torch.bfloat16:
        return torch.bfloat16 if ndim >= 2 else torch.float32
    return dtype


def convert_causal_wan_state_dict(sd: Dict[str, Any], cfg: ModelConfig,
                                  dtype: torch.dtype = torch.bfloat16,
                                  device: str | torch.device = "cuda") -> Params:
    """The reference `CausalWanModel` state dict -> the causal-DiT tree on
    `device` (the name map of `causal_model.py:518-658`). A missing key
    raises KeyError."""
    dev = resolve_device(device)

    def host(x, name: str, ndim: Optional[int] = None) -> torch.Tensor:
        # one rounding, as the JAX loader's cast of the float32 value (a
        # widening to float32 first changes no value); no copy where the
        # dtype and layout already fit (stacking and the device copy below
        # make the tree's own tensors)
        x = torch.as_tensor(x).detach().to("cpu")
        final = _host_dtype(name, x.dim() if ndim is None else ndim, dtype)
        return x.to(final)

    def lin(prefix: str, name: str, stacked: bool = False) -> Params:
        extra = 1 if stacked else 0
        w = torch.as_tensor(sd[f"{prefix}.weight"])
        b = torch.as_tensor(sd[f"{prefix}.bias"])
        return {"w": host(w.t(), f"{name}/w", w.dim() + extra),
                "b": host(b, f"{name}/b", b.dim() + extra)}

    pw = torch.as_tensor(sd["patch_embedding.weight"])
    d_out, c_in, pt, ph, pw2 = pw.shape
    patch_w = pw.permute(2, 3, 4, 1, 0).reshape(pt * ph * pw2 * c_in, d_out)
    params: Params = {
        "patch_embedding": {"w": host(patch_w, "patch_embedding/w"),
                            "b": host(sd["patch_embedding.bias"], "patch_embedding/b")},
        "text_embedding": {"fc1": lin("text_embedding.0", "text_embedding/fc1"),
                           "fc2": lin("text_embedding.2", "text_embedding/fc2")},
        "time_embedding": {"fc1": lin("time_embedding.0", "time_embedding/fc1"),
                           "fc2": lin("time_embedding.2", "time_embedding/fc2")},
        "time_projection": lin("time_projection.1", "time_projection"),
        "head": {"head": lin("head.head", "head/head"),
                 "modulation": host(torch.as_tensor(sd["head.modulation"]).reshape(2, -1),
                                    "head/modulation")},
    }

    def norm(key: str) -> torch.Tensor:
        return host(sd[key], "blocks/norm", 2)

    blocks: List[Params] = []
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"

        def attn(kind: str) -> Params:
            a = {n: lin(f"{p}.{kind}.{n}", f"blocks/{kind}/{n}", stacked=True)
                 for n in ("q", "k", "v", "o")}
            a["norm_q"] = {"w": norm(f"{p}.{kind}.norm_q.weight")}
            a["norm_k"] = {"w": norm(f"{p}.{kind}.norm_k.weight")}
            return a

        blocks.append({
            "self_attn": attn("self_attn"),
            "cross_attn": attn("cross_attn"),
            "norm3": {"w": norm(f"{p}.norm3.weight"), "b": norm(f"{p}.norm3.bias")},
            "ffn": {"fc1": lin(f"{p}.ffn.0", "blocks/ffn/fc1", stacked=True),
                    "fc2": lin(f"{p}.ffn.2", "blocks/ffn/fc2", stacked=True)},
            "modulation": host(torch.as_tensor(sd[f"{p}.modulation"]).reshape(6, -1),
                               "blocks/modulation"),
        })
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return tree_map(lambda x: x.to(dev, copy=True, memory_format=torch.contiguous_format),
                    params)


def load_self_forcing_checkpoint(model_path: str, cfg: ModelConfig,
                                 dtype: torch.dtype = torch.bfloat16,
                                 device: str | torch.device = "cuda") -> Params:
    """A Self-Forcing / CausVid checkpoint: a directory (its first .pt,
    .pth or .bin in sorted order) or a file."""
    if os.path.isdir(model_path):
        candidates = [f for f in os.listdir(model_path)
                      if f.endswith((".pt", ".pth", ".bin"))]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {model_path}")
        path = os.path.join(model_path, sorted(candidates)[0])
    else:
        path = model_path
    return convert_causal_wan_state_dict(load_torch_state_dict(path), cfg, dtype, device)


# ---------------------------------------------------------------------------
# VAE weights
# ---------------------------------------------------------------------------

def convert_wan_vae_state_dict(sd: Dict[str, Any], cfg=None,
                               device: str | torch.device = "cuda") -> Params:
    """The reference `WanVAE_` state dict -> the VAE tree
    (`{"encoder", "decoder", "conv1", "conv2"}`) on `device`, in float32.
    The reference module tree (`vae.py:477-512`) is walked in the order the
    port's `init_vae_params` builds it. cfg: the checkpoint's `VAEConfig`
    (Wan2.1's when None). A missing key raises KeyError."""
    from ..models.wan.vae import VAEConfig

    if cfg is None:
        cfg = VAEConfig()
    dev = resolve_device(device)

    def f32(x) -> torch.Tensor:
        return torch.as_tensor(x).detach().to("cpu").to(torch.float32, copy=True)

    def conv3d(prefix: str) -> Params:
        w = f32(sd[f"{prefix}.weight"])
        if w.dim() == 4:   # Conv2d [out, in, kh, kw] -> [1, kh, kw, in, out]
            w = w.permute(2, 3, 1, 0)[None]
        else:              # Conv3d [out, in, kt, kh, kw]
            w = w.permute(2, 3, 4, 1, 0)
        return {"w": w.contiguous(), "b": f32(sd[f"{prefix}.bias"])}

    def gamma(prefix: str) -> Params:
        return {"gamma": f32(sd[f"{prefix}.gamma"]).reshape(-1)}

    def res(prefix: str) -> Params:
        p = {"norm1": gamma(f"{prefix}.residual.0"), "conv1": conv3d(f"{prefix}.residual.2"),
             "norm2": gamma(f"{prefix}.residual.3"), "conv2": conv3d(f"{prefix}.residual.6")}
        if f"{prefix}.shortcut.weight" in sd:
            p["shortcut"] = conv3d(f"{prefix}.shortcut")
        return p

    def attn(prefix: str) -> Params:
        return {"norm": gamma(f"{prefix}.norm"), "qkv": conv3d(f"{prefix}.to_qkv"),
                "proj": conv3d(f"{prefix}.proj")}

    def middle(prefix: str) -> Params:
        return {"res1": res(f"{prefix}.middle.0"), "attn": attn(f"{prefix}.middle.1"),
                "res2": res(f"{prefix}.middle.2")}

    def resample(prefix: str, mode: str) -> Params:
        rp = {"conv": conv3d(f"{prefix}.resample.1")}
        if mode in ("downsample3d", "upsample3d"):
            rp["time_conv"] = conv3d(f"{prefix}.time_conv")
        return {f"resample:{mode}": rp}

    last = len(cfg.dim_mult) - 1
    enc: Params = {"conv1": conv3d("encoder.conv1")}
    downs, idx = [], 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks):
            downs.append({"res": res(f"encoder.downsamples.{idx}")})
            idx += 1
        if i != last:
            mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
            downs.append(resample(f"encoder.downsamples.{idx}", mode))
            idx += 1
    enc.update(downsamples=downs, middle=middle("encoder"),
               head_norm=gamma("encoder.head.0"), head_conv=conv3d("encoder.head.2"))

    dec: Params = {"conv1": conv3d("decoder.conv1"), "middle": middle("decoder")}
    ups, idx = [], 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            ups.append({"res": res(f"decoder.upsamples.{idx}")})
            idx += 1
        if i != last:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            ups.append(resample(f"decoder.upsamples.{idx}", mode))
            idx += 1
    dec.update(upsamples=ups, head_norm=gamma("decoder.head.0"),
               head_conv=conv3d("decoder.head.2"))

    out = {"conv1": conv3d("conv1"), "conv2": conv3d("conv2"), "encoder": enc, "decoder": dec}
    return tree_map(lambda x: x.to(dev), out)


def load_wan_vae(vae_path: str, cfg=None, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", conv_impl: str = "xla"):
    """`Wan2.1_VAE.pth` -> a `CausalVAE` with its weights, in `dtype`, with
    `conv_impl` (see `models.wan.vae`)."""
    from ..models.wan.vae import CausalVAE, VAEConfig

    if cfg is None:
        cfg = VAEConfig()
    params = convert_wan_vae_state_dict(load_torch_state_dict(vae_path), cfg, device)
    return CausalVAE(cfg, params=params, dtype=dtype, device=device, conv_impl=conv_impl)


# ---------------------------------------------------------------------------
# MAGI-1 DiT weights (bf16 or the fp8 distill-quant layout, learned rope)
# ---------------------------------------------------------------------------

def _stack(leaves: List[torch.Tensor]) -> torch.Tensor:
    """torch.stack; e4m3 leaves through uint8 views (bits carried)."""
    if leaves[0].dtype == torch.float8_e4m3fn:
        return torch.stack([x.view(torch.uint8) for x in leaves]).view(torch.float8_e4m3fn)
    return torch.stack(leaves)


def convert_magi_state_dict(sd: Dict[str, Any], cfg, dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device = "cuda") -> Params:
    """The reference MAGI `VideoDiTModel` state dict -> the MAGI DiT tree
    (`models.magi.dit`) on `device`, with the JAX converter's leaf dtypes.

    Middle layers of the shipped fp8 "distill_quant" checkpoints carry e4m3
    weights [1, out, in] + weight_scale / input_scale (/ smooth_scale);
    first and last layers stay plain, and the tree then holds
    `blocks_first`, stacked `blocks_mid` and `blocks_last` instead of
    stacked `blocks`. The learned rotary bands (`rope.bands`) become
    `rope_bands`. Linear weights [out, in] -> [in, out]; the Conv3d
    x_embedder [h, C, tp, ph, pw] -> a matmul [(tp ph pw C), h] in the
    patchify's feature order. e4m3 values are carried exactly (read as
    e4m3, or as float32 values of e4m3 codes). cfg: a `MagiModelConfig`. A
    missing key raises KeyError."""
    dev = resolve_device(device)
    f32 = torch.float32

    def host(name, dt=None) -> torch.Tensor:
        x = torch.as_tensor(sd[name]).detach().to("cpu")
        return x if dt is None else x.to(dt)

    def lin_t(name, dt=dtype, bias=False) -> Params:
        p = {"w": host(f"{name}.weight").t().to(dt)}
        if bias:
            p["b"] = host(f"{name}.bias", dt)
        return p

    def maybe_quant_lin(name) -> Params:
        """A plain or an fp8 linear, as the checkpoint's tensors say."""
        if f"{name}.weight_scale" not in sd:
            return lin_t(name)
        w = host(f"{name}.weight")
        w = w.reshape(w.shape[-2], w.shape[-1]).t()
        if w.dtype != torch.float8_e4m3fn:
            w = w.to(f32).to(torch.float8_e4m3fn)
        p = {"w_q": w, "weight_scale": host(f"{name}.weight_scale", f32).reshape(())}
        if f"{name}.smooth_scale" in sd:                # per-channel
            p["smooth_scale"] = host(f"{name}.smooth_scale", f32).reshape(-1)
            p["input_scale"] = host(f"{name}.input_scale", f32).reshape(())
        else:                                           # per-tensor
            p["act_scale"] = host(f"{name}.input_scale", f32).reshape(-1)
        return p

    def ln_t(name, dt=f32) -> Params:
        return {"w": host(f"{name}.weight", dt), "b": host(f"{name}.bias", dt)}

    def block(i: int) -> Params:
        pre = f"videodit_blocks.layers.{i}"
        att = f"{pre}.self_attention"
        return {
            "ln_qkv": ln_t(f"{att}.linear_qkv.layer_norm", dtype),
            "q": maybe_quant_lin(f"{att}.linear_qkv.q"),
            "qx": maybe_quant_lin(f"{att}.linear_qkv.qx"),
            "k": maybe_quant_lin(f"{att}.linear_qkv.k"),
            "v": maybe_quant_lin(f"{att}.linear_qkv.v"),
            "q_ln": ln_t(f"{att}.q_layernorm"),
            "qx_ln": ln_t(f"{att}.q_layernorm_xattn"),
            "k_ln": ln_t(f"{att}.k_layernorm"),
            "kx_ln": ln_t(f"{att}.k_layernorm_xattn"),
            "kv_xattn": lin_t(f"{att}.linear_kv_xattn"),
            "proj": maybe_quant_lin(f"{att}.linear_proj"),
            "ada_proj": lin_t(f"{pre}.ada_modulate_layer.proj.0", f32, bias=True),
            "self_post_norm": ln_t(f"{pre}.self_attn_post_norm"),
            "mlp_post_norm": ln_t(f"{pre}.mlp_post_norm"),
            "mlp_ln": ln_t(f"{pre}.mlp.layer_norm", dtype),
            "fc1": maybe_quant_lin(f"{pre}.mlp.linear_fc1"),
            "fc2": maybe_quant_lin(f"{pre}.mlp.linear_fc2"),
        }

    blocks = [block(i) for i in range(cfg.num_layers)]
    w = host("x_embedder.weight")
    h_dim = w.shape[0]
    w = w.reshape(h_dim, cfg.in_channels, cfg.t_patch_size, cfg.patch_size, cfg.patch_size)
    params: Params = {
        "x_embedder": {"w": w.permute(2, 3, 4, 1, 0).reshape(-1, h_dim).to(dtype)},
        "t_embedder": {"fc1": lin_t("t_embedder.mlp.0", f32, bias=True),
                       "fc2": lin_t("t_embedder.mlp.2", f32, bias=True)},
        "y_embedder": {
            "y_proj_xattn": lin_t("y_embedder.y_proj_xattn.0", dtype, bias=True),
            "y_proj_adaln": lin_t("y_embedder.y_proj_adaln.0", f32, bias=True),
            "null_caption_embedding": host("y_embedder.null_caption_embedding", dtype),
        },
        "rope_bands": host("rope.bands", f32),
        "final_layernorm": ln_t("videodit_blocks.final_layernorm"),
        "final_linear": lin_t("final_linear.linear"),
    }
    if any("w_q" in b["q"] for b in blocks):
        params["blocks_first"] = blocks[0]
        params["blocks_mid"] = tree_map(lambda *xs: _stack(list(xs)), *blocks[1:-1])
        params["blocks_last"] = blocks[-1]
    else:
        params["blocks"] = tree_map(lambda *xs: _stack(list(xs)), *blocks)
    return tree_map(lambda x: x.to(dev, copy=True, memory_format=torch.contiguous_format),
                    params)


# ---------------------------------------------------------------------------
# MAGI ViT-VAE weights (learnable pos embeds + rotary)
# ---------------------------------------------------------------------------

_VITVAE_KEYS = ("video_size", "video_length", "patch_size", "patch_length", "in_chans",
                "z_chans", "double_z", "embed_dim", "depth", "num_heads", "mlp_ratio",
                "qkv_bias", "with_cls_token", "ln_in_attn", "use_rope", "use_final_proj",
                "norm_code")


def vitvae_config_from_ddconfig(dd: Dict[str, Any], **overrides):
    """The reference checkpoint's `config.json` ddconfig -> ViTVAEConfig
    (the ddconfig keys the reference `ViTVAE` reads; others are ignored)."""
    from ..models.magi.vae import ViTVAEConfig

    kwargs = {k: dd[k] for k in _VITVAE_KEYS if k in dd}
    kwargs.update(overrides)
    return ViTVAEConfig(**kwargs)


def convert_magi_vae_state_dict(sd: Dict[str, Any], cfg,
                                device: str | torch.device = "cuda") -> Params:
    """The reference MAGI `ViTVAE` state dict -> the ViT-VAE tree
    (`models.magi.vae`) on `device`, every leaf float32.

    `pos_embed` [1, N+cls, D] and `cls_token` load verbatim (the rotary
    tables have no parameters); the Conv3d patch embedding [D, C, pl, ps,
    ps] flattens to the (C, pl, ph, pw)-ordered patch matmul [(C pl ph pw),
    D]; the decoder's 3x3x3 `last_layer` Conv3d [O, I, kd, kh, kw]
    transposes to channels-last DHWIO; linears [out, in] -> [in, out]; the
    blocks are stacked on a leading [depth] axis. Converted on the host,
    each leaf copied to the device once."""
    dev = resolve_device(device)

    def host(name) -> torch.Tensor:
        return torch.as_tensor(sd[name]).detach().to("cpu", torch.float32)

    def lin_t(name) -> Params:
        p = {"w": host(f"{name}.weight").t()}
        if f"{name}.bias" in sd:
            p["b"] = host(f"{name}.bias")
        return p

    def ln_t(name) -> Params:
        return {"w": host(f"{name}.weight"), "b": host(f"{name}.bias")}

    def block_t(prefix) -> Params:
        p = {"qkv": lin_t(f"{prefix}.attn.qkv"), "proj": lin_t(f"{prefix}.attn.proj"),
             "norm2": ln_t(f"{prefix}.norm2"), "fc1": lin_t(f"{prefix}.mlp.fc1"),
             "fc2": lin_t(f"{prefix}.mlp.fc2")}
        if not cfg.ln_in_attn:
            p["norm1"] = ln_t(f"{prefix}.norm1")
        return p

    def tower(side, first, last) -> Params:
        blocks = [block_t(f"{side}.blocks.{i}") for i in range(cfg.depth)]
        t = {**first, "pos_embed": host(f"{side}.pos_embed")[0],
             "blocks": tree_map(lambda *xs: torch.stack(xs), *blocks),
             "norm": ln_t(f"{side}.norm"), **last}
        if cfg.with_cls_token:
            t["cls_token"] = host(f"{side}.cls_token").reshape(-1)
        return t

    d = cfg.embed_dim
    enc_patch = {"w": host("encoder.patch_embed.proj.weight").reshape(d, -1).t(),
                 "b": host("encoder.patch_embed.proj.bias")}
    enc = tower("encoder", {"patch": enc_patch}, {"last": lin_t("encoder.last_layer")})
    dec_last = {"last_conv": {"w": host("decoder.last_layer.weight").permute(2, 3, 4, 1, 0),
                              "b": host("decoder.last_layer.bias")}}
    if cfg.use_final_proj:
        dec_last["final_proj"] = lin_t("decoder.final_proj")
        dec_last["final_norm"] = ln_t("decoder.final_norm")
    dec = tower("decoder", {"proj_in": lin_t("decoder.proj_in")}, dec_last)
    return tree_map(lambda x: x.to(dev, copy=True, memory_format=torch.contiguous_format),
                    {"encoder": enc, "decoder": dec})


def load_magi_vae(path: str, device: str | torch.device = "cuda", **config_overrides):
    """A MAGI VAE checkpoint directory (diffusers layout: `config.json`,
    its `ddconfig` or flat, and `diffusion_pytorch_model.safetensors` /
    `model.safetensors`, read by `read_safetensors`, else
    `diffusion_pytorch_model.bin` / `pytorch_model.bin`) -> a `ViTVAE` on
    `device`."""
    from ..models.magi.vae import ViTVAE

    with open(os.path.join(path, "config.json")) as f:
        conf = json.load(f)
    cfg = vitvae_config_from_ddconfig(conf.get("ddconfig", conf), **config_overrides)
    sd = None
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            sd = read_safetensors(p)
            break
    if sd is None:
        for name in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                sd = load_torch_state_dict(p)
                break
    if sd is None:
        raise FileNotFoundError(f"no weights found under {path}")
    return ViTVAE(cfg, params=convert_magi_vae_state_dict(sd, cfg, device), device=device)
