"""Wan 2.1 causal 3D VAE, encode and decode (port of
`inferix_tpu/models/wan/vae.py`).

Latents [B, T, h, w, z] (channels last, normalised per channel) decode
chunk by chunk into pixels [B, 1 + 4(T - 1), 8h, 8w, 3] in [-1, 1]. Each
temporal conv keeps the last kt - 1 input frames of the previous chunk in an
explicit cache dict (zeros at the stream's start, the reference's causal
padding), so decoding in chunks equals decoding frame by frame; the first
chunk's 'Rep' rule passes the stream's first frame through the temporal
upsample untouched. Encoding runs the other way, pixels [B, 1 + 4k, H, W, 3]
in chunks of 1 frame, then 4, to latents [B, 1 + k, H/8, W/8, z] (the
posterior mean, normalised); its temporal downsample keeps the last frame of
the previous chunk.

The JAX package's process-wide switches `set_vae_conv_impl` and
`set_vae_upsample_impl` are arguments of `CausalVAE` here:
- conv_impl "xla": every conv is `F.conv3d` (cuDNN on the card), as the JAX
  package runs its convs in XLA;
- "shifted_matmul": stride-1 convs as kt*kh*kw tap-shifted matrix products
  in f32;
- "halo": the 3x3x3 stride-1 SAME convs whose frames hold H*W >= 256 pixels
  go to `ops.halo_conv.halo_conv3d` (the bf16 halo conv kernel on the card),
  the encoder's RGB input conv (Cin 3) included;
- "halo_w8a8": those and the 1x3x3 upsample convs go to
  `halo_conv3d_w8a8` (the W8A8 kernel; a lossy serving mode). The encoder's
  1x3x3 downsample convs have stride 2 and stay on `F.conv3d`, as the JAX
  package keeps them on `lax.conv`, and so does every temporal `time_conv`.
The kernels run on CUDA tensors and their plain versions on CPU tensors;
where the JAX package falls back to XLA off the TPU, the port never falls
back on the card. upsample_impl "repeat" (nearest 2x, then the 3x3 conv) or
"phase" (four 2x2 convs at low resolution, exact; not under halo_w8a8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...ops.attention import attention_chunked
from ...ops.halo_conv import halo_conv3d, halo_conv3d_w8a8, pack_weight, tap_sum
from ...profiling.profiler import span

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

CONV_IMPLS = ("xla", "shifted_matmul", "halo", "halo_w8a8")
UPSAMPLE_IMPLS = ("repeat", "phase")

# Per-channel latent normalisation (the reference's
# `models/self_forcing/wrapper.py:65-74`).
LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Defaults are Wan2.1_VAE's: dim 96, z 16, dim_mult (1, 2, 4, 4), 2 res
    blocks, temporal downsample (False, True, True)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temperal_downsample)

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)


# ---------------------------------------------------------------------------
# Primitive layers (x is [B, T, H, W, C] throughout)
# ---------------------------------------------------------------------------

def _spatial_pads(kh: int, kw: int, spatial_pad: str):
    if spatial_pad == "same":
        return ((kh - 1) // 2, (kh - 1) // 2), ((kw - 1) // 2, (kw - 1) // 2)
    if spatial_pad == "down":  # ZeroPad2d((0, 1, 0, 1)) as in Resample
        return (0, 1), (0, 1)
    return (0, 0), (0, 0)


def _pad_hw(x: torch.Tensor, ph, pw) -> torch.Tensor:
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def _conv3d_shifted_matmul(p: Params, x: torch.Tensor,
                           spatial_pad: str) -> torch.Tensor:
    """Stride-1 conv as kt*kh*kw tap-shifted matrix products in f32 on x
    and w in x's dtype; temporal VALID (the causal caller prepends kt - 1
    frames)."""
    kh, kw = p["w"].shape[1:3]
    xp = _pad_hw(x, *_spatial_pads(kh, kw, spatial_pad)).float()
    out = tap_sum(xp, p["w"].to(x.dtype).float(), torch.float32) + p["b"].float()
    return out.to(x.dtype)


def _halo_weight(w: torch.Tensor, conv_impl: str) -> bool:
    """Whether a conv of weight w [kt, kh, kw, Cin, Cout] is of the class the
    halo kernel of conv_impl takes (the JAX gate, `vae.py:170-203`): the
    bf16 kernel the 3x3x3 convs, the W8A8 one the 1x3x3 upsample convs as
    well."""
    kt, kh, kw = w.shape[:3]
    kt_ok = (kt == 3) if conv_impl == "halo" else (kt in (1, 3))
    return conv_impl in ("halo", "halo_w8a8") and kt_ok and kh == 3 and kw == 3


def _conv3d(p: Params, x: torch.Tensor, conv_impl: str, t_stride: int = 1,
            s_stride: int = 1, spatial_pad: str = "same") -> torch.Tensor:
    """x [B, T, H, W, C]; temporal padding is the caller's (causal). A conv
    the halo gate takes uses its kernel operand p["packed"] where the
    caller built one (`CausalVAE` does on the card)."""
    kt, kh, kw = p["w"].shape[:3]
    if (_halo_weight(p["w"], conv_impl) and t_stride == 1 and s_stride == 1
            and spatial_pad == "same" and x.shape[2] * x.shape[3] >= 256):
        kern = halo_conv3d_w8a8 if conv_impl == "halo_w8a8" else halo_conv3d
        return torch.stack([kern(x[i], p["w"], p["b"], packed=p.get("packed"))
                            for i in range(x.shape[0])])
    if (conv_impl == "shifted_matmul" and t_stride == 1 and s_stride == 1
            and kt * kh * kw > 1):
        return _conv3d_shifted_matmul(p, x, spatial_pad)
    x = _pad_hw(x, *_spatial_pads(kh, kw, spatial_pad))
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 p["w"].to(x.dtype).permute(4, 3, 0, 1, 2),
                 stride=(t_stride, s_stride, s_stride))
    return y.permute(0, 2, 3, 4, 1) + p["b"].to(x.dtype)


class _CacheCtx:
    """Threads the per-conv cache dict through the apply calls (the
    reference's feat_cache list and feat_idx counter)."""

    def __init__(self, cache: Optional[Cache], first: bool, conv_impl: str,
                 upsample_impl: str):
        self.cache = dict(cache) if cache else {}
        self.first = first
        self.conv_impl = conv_impl
        self.upsample_impl = upsample_impl
        self._n = 0

    def slot(self) -> str:
        name = f"c{self._n}"
        self._n += 1
        return name

    def pull(self, name: str, like: torch.Tensor, shape) -> torch.Tensor:
        if name in self.cache:
            return self.cache[name]
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    def push(self, name: str, value: torch.Tensor) -> None:
        self.cache[name] = value


def causal_conv3d(p: Params, x: torch.Tensor, ctx: _CacheCtx) -> torch.Tensor:
    """Temporally causal conv: prepend the rolling (kt - 1)-frame cache
    (zeros at the stream's start, the reference's causal zero padding)."""
    kt = p["w"].shape[0]
    if kt == 1:
        return _conv3d(p, x, ctx.conv_impl)
    name = ctx.slot()
    b, _, h, w, c = x.shape
    x_in = torch.cat([ctx.pull(name, x, (b, kt - 1, h, w, c)), x], dim=1)
    ctx.push(name, x_in[:, -(kt - 1):])
    return _conv3d(p, x_in, ctx.conv_impl)


def rms_norm_spatial(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The reference RMS_norm: L2-normalise over channels, times sqrt(C) and
    gamma, in f32."""
    c = x.shape[-1]
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    out = xf / torch.clamp_min(norm, eps) * math.sqrt(c)
    return (out * p["gamma"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def res_block(p: Params, x: torch.Tensor, ctx: _CacheCtx) -> torch.Tensor:
    h = _conv3d(p["shortcut"], x, ctx.conv_impl) if "shortcut" in p else x
    y = F.silu(rms_norm_spatial(p["norm1"], x))
    y = causal_conv3d(p["conv1"], y, ctx)
    y = F.silu(rms_norm_spatial(p["norm2"], y))
    y = causal_conv3d(p["conv2"], y, ctx)
    return y + h


def attn_block(p: Params, x: torch.Tensor, conv_impl: str) -> torch.Tensor:
    """Single-head per-frame spatial attention. Frames of H*W >= 4096
    pixels go through the chunked online-softmax attention (the JAX
    package's choice: a [T, 6240, 6240] f32 logits tensor otherwise)."""
    b, t, h, w, c = x.shape
    y = rms_norm_spatial(p["norm"], x)
    qkv = _conv3d(p["qkv"], y, conv_impl).reshape(b * t, h * w, 3, c)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if h * w >= 4096:
        o, _ = attention_chunked(q[:, :, None], k[:, :, None], v[:, :, None],
                                 chunk_size=2048)
        o = o[:, :, 0]
    else:
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v)
    return x + _conv3d(p["proj"], o.reshape(b, t, h, w, c), conv_impl)


def _upsample2x_conv3x3(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x spatial upsample + 3x3 SAME conv as four phase-wise 2x2
    convs at low resolution: output pixel (2i+di, 2j+dj) reads two source
    rows and two source columns with the 3x3 weights summed pairwise
    (exact up to reassociation)."""
    w = p["w"]  # [1, 3, 3, cin, cout]
    b_, t, h, wd, _ = x.shape
    row = {0: torch.stack([w[:, 0], w[:, 1] + w[:, 2]], dim=1),
           1: torch.stack([w[:, 0] + w[:, 1], w[:, 2]], dim=1)}
    pad = {0: (1, 0), 1: (0, 1)}
    phases = []
    for di in (0, 1):
        for dj in (0, 1):
            wk = row[di]
            if dj == 0:
                wk = torch.stack([wk[:, :, 0], wk[:, :, 1] + wk[:, :, 2]], dim=2)
            else:
                wk = torch.stack([wk[:, :, 0] + wk[:, :, 1], wk[:, :, 2]], dim=2)
            xp = _pad_hw(x, pad[di], pad[dj])
            y = F.conv3d(xp.permute(0, 4, 1, 2, 3),
                         wk.to(x.dtype).permute(4, 3, 0, 1, 2))
            phases.append(y.permute(0, 2, 3, 4, 1))
    cout = phases[0].shape[-1]
    y = torch.stack(phases, dim=4).reshape(b_, t, h, wd, 2, 2, cout)
    y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b_, t, 2 * h, 2 * wd, cout)
    return y + p["b"].to(x.dtype)


def resample(p: Params, x: torch.Tensor, ctx: _CacheCtx, mode: str) -> torch.Tensor:
    if mode in ("downsample2d", "downsample3d"):
        x = _conv3d(p["conv"], x, ctx.conv_impl, s_stride=2, spatial_pad="down")
        if mode == "downsample3d":
            name = ctx.slot()
            if ctx.first:
                # the stream's first frame passes; it seeds the cache
                ctx.push(name, x[:, -1:])
            else:
                cache = ctx.pull(name, x, (x.shape[0], 1, *x.shape[2:]))
                ctx.push(name, x[:, -1:])
                x = _conv3d(p["time_conv"], torch.cat([cache, x], dim=1),
                            ctx.conv_impl, t_stride=2, spatial_pad="none")
        return x
    if mode not in ("upsample2d", "upsample3d"):
        raise ValueError(f"unknown resample mode {mode!r}")
    b, t, h, w, c = x.shape
    if mode == "upsample3d":
        name = ctx.slot()
        if not (ctx.first and t == 1):  # else the 'Rep' frame passes through
            if ctx.first:
                # frame 0 is the 'Rep' passthrough; frames 1..t-1 run the
                # cached path seeded with the zeros a per-frame stream has
                head, tail = x[:, :1], x[:, 1:]
                x_in = torch.cat([x.new_zeros(b, 2, h, w, c), tail], dim=1)
            else:
                head = None
                x_in = torch.cat([ctx.pull(name, x, (b, 2, h, w, c)), x], dim=1)
            ctx.push(name, x_in[:, -2:])
            tt = x_in.shape[1] - 2
            y = _conv3d(p["time_conv"], x_in, ctx.conv_impl, spatial_pad="none")
            # interleave: channel groups (2, C) -> doubled frames
            y = y.reshape(b, tt, h, w, 2, c).permute(0, 1, 4, 2, 3, 5)
            y = y.reshape(b, tt * 2, h, w, c)
            x = y if head is None else torch.cat([head, y], dim=1)
    if ctx.upsample_impl == "phase" and ctx.conv_impl != "halo_w8a8":
        return _upsample2x_conv3x3(p["conv"], x)
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return _conv3d(p["conv"], x, ctx.conv_impl)


# ---------------------------------------------------------------------------
# Encoder / Decoder
# ---------------------------------------------------------------------------

def encoder_apply(p: Params, x: torch.Tensor, ctx: _CacheCtx) -> torch.Tensor:
    x = causal_conv3d(p["conv1"], x, ctx)
    for layer in p["downsamples"]:
        if "res" in layer:
            x = res_block(layer["res"], x, ctx)
        elif "attn" in layer:
            x = attn_block(layer["attn"], x, ctx.conv_impl)
        else:
            (key,) = layer.keys()
            x = resample(layer[key], x, ctx, mode=key.split(":")[1])
    x = res_block(p["middle"]["res1"], x, ctx)
    x = attn_block(p["middle"]["attn"], x, ctx.conv_impl)
    x = res_block(p["middle"]["res2"], x, ctx)
    x = F.silu(rms_norm_spatial(p["head_norm"], x))
    return causal_conv3d(p["head_conv"], x, ctx)


def decoder_apply(p: Params, x: torch.Tensor, ctx: _CacheCtx) -> torch.Tensor:
    x = causal_conv3d(p["conv1"], x, ctx)
    x = res_block(p["middle"]["res1"], x, ctx)
    x = attn_block(p["middle"]["attn"], x, ctx.conv_impl)
    x = res_block(p["middle"]["res2"], x, ctx)
    for layer in p["upsamples"]:
        if "res" in layer:
            x = res_block(layer["res"], x, ctx)
        elif "attn" in layer:
            x = attn_block(layer["attn"], x, ctx.conv_impl)
        else:
            (key,) = layer.keys()
            x = resample(layer[key], x, ctx, mode=key.split(":")[1])
    x = F.silu(rms_norm_spatial(p["head_norm"], x))
    return causal_conv3d(p["head_conv"], x, ctx)


def _cast_tree(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _pack_halo_weights(tree, conv_impl: str) -> None:
    """Give every conv of the tree that the halo gate of conv_impl takes
    its kernel operand, p["packed"], built once (in place)."""
    children = tree.values() if isinstance(tree, dict) else tree
    if isinstance(tree, dict) and "w" in tree and _halo_weight(tree["w"], conv_impl):
        tree["packed"] = pack_weight(tree["w"], w8a8=conv_impl == "halo_w8a8")
    for child in children:
        if isinstance(child, (dict, list)):
            _pack_halo_weights(child, conv_impl)


class CausalVAE:
    """Chunked streaming encode and decode of the Wan causal VAE.

    params: the JAX package's tree (`{"encoder", "decoder", "conv1",
    "conv2"}`, e.g. from `utils.params.params_from_numpy`; a tree without
    the encoder and conv1 decodes only), or None to draw one from seed 0
    (`utils.params.init_vae_params`).
    float32 leaves are cast to `dtype` (bf16 is the serving dtype). On the
    card the halo conv impls lay out the weights of the convs their kernel
    takes once, here."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), params: Optional[Params] = None,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", conv_impl: str = "xla",
                 upsample_impl: str = "repeat"):
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl must be one of {UPSAMPLE_IMPLS}, "
                             f"got {upsample_impl!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.conv_impl = conv_impl
        self.upsample_impl = upsample_impl
        if params is None:
            from ...utils.params import init_vae_params
            params = init_vae_params(
                cfg, torch.Generator(device=self.device).manual_seed(0), self.device)
        self.params = _cast_tree({k: params[k] for k in ("encoder", "decoder", "conv1",
                                                         "conv2") if k in params}, dtype)
        if self.device.type == "cuda":
            _pack_halo_weights(self.params, conv_impl)

    def _latent_stats(self, like: torch.Tensor):
        z = self.cfg.z_dim
        mean, std = LATENT_MEAN, LATENT_STD
        if z <= mean.shape[0]:
            mean, std = mean[:z], std[:z]
        else:
            mean = np.pad(mean, (0, z - mean.shape[0]))
            std = np.pad(std, (0, z - std.shape[0]), constant_values=1.0)
        return (torch.from_numpy(mean).to(device=like.device, dtype=like.dtype),
                torch.from_numpy(std).to(device=like.device, dtype=like.dtype))

    @torch.inference_mode()
    def decode_chunk(self, z: torch.Tensor, cache: Optional[Cache],
                     first: bool) -> Tuple[torch.Tensor, Cache]:
        """Decode T latent frames [B, T, h, w, z] -> pixels [B, 4T or 4T - 3,
        H, W, 3] (the stream's first frame expands to one pixel frame, every
        other to four), carrying the temporal cache from chunk to chunk."""
        with span("vae.decode", first=first):
            ctx = _CacheCtx(cache, first, self.conv_impl, self.upsample_impl)
            z = z.to(device=self.device, dtype=self.dtype)
            mean, std = self._latent_stats(z)
            x = _conv3d(self.params["conv2"], z * std + mean, self.conv_impl)
            out = decoder_apply(self.params["decoder"], x, ctx)
        return out, ctx.cache

    def decode(self, latents: torch.Tensor, chunk: int = 3) -> torch.Tensor:
        """latents [B, T, h, w, z] -> video [B, 1 + 4(T - 1), H, W, 3] in
        [-1, 1], `chunk` latent frames a call (equal to frame-by-frame
        streaming up to reassociation)."""
        chunks: List[torch.Tensor] = []
        cache: Optional[Cache] = None
        for i in range(0, latents.shape[1], chunk):
            out, cache = self.decode_chunk(latents[:, i:i + chunk], cache,
                                           first=(i == 0))
            chunks.append(out)
        return torch.clamp(torch.cat(chunks, dim=1), -1.0, 1.0)

    @torch.inference_mode()
    def encode_chunk(self, x: torch.Tensor, cache: Optional[Cache],
                     first: bool) -> Tuple[torch.Tensor, Cache]:
        """Encode pixel frames [B, T, H, W, 3] (the stream's first chunk 1
        frame, every other 4) to the normalised posterior mean [B, 1, H/8,
        W/8, z], carrying the temporal cache from chunk to chunk."""
        if "encoder" not in self.params:
            raise ValueError("these VAE parameters hold no encoder")
        ctx = _CacheCtx(cache, first, self.conv_impl, self.upsample_impl)
        x = x.to(device=self.device, dtype=self.dtype)
        out = encoder_apply(self.params["encoder"], x, ctx)
        mu = _conv3d(self.params["conv1"], out, self.conv_impl)[..., :self.cfg.z_dim]
        mean, std = self._latent_stats(mu)
        return (mu - mean) / std, ctx.cache

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1] with T = 1 + 4k -> latents
        [B, 1 + k, H/8, W/8, z]: the first frame alone, then 4 frames a
        chunk."""
        t = video.shape[1]
        if (t - 1) % 4:
            raise ValueError(f"pixel frames must be 1 + 4k, got {t}")
        outs: List[torch.Tensor] = []
        cache: Optional[Cache] = None
        pos = 0
        for i in range(1 + (t - 1) // 4):
            n = 1 if i == 0 else 4
            out, cache = self.encode_chunk(video[:, pos:pos + n], cache, first=(i == 0))
            outs.append(out)
            pos += n
        return torch.cat(outs, dim=1)
