"""Plain float32 reference of the Wan2.1 causal VAE decoder, chunk by chunk.

Written from the Wan2.1 VAE (`Wan2.1_VAE`: z 16, dim 96, dim_mult (1, 2, 4,
4), 2 residual blocks a stage, temporal upsampling in the first two stages):
causal 3D convolutions that carry the last kt - 1 input frames of the
previous chunk (zeros at the stream's start), RMS norms over channels,
one spatial self-attention a frame in the middle block, nearest 2x upsampling
with a 1x3x3 convolution, and a time convolution doubling the frames (the
stream's first frame passes through it untouched). Channels-last tensors
[T, H, W, C] of one stream, float32, F.conv3d with TF32 off. It imports
nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .wan_dit import fp32_tree

LATENT_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
               0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
LATENT_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
              3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)
ATTN_ROWS = 2048  # query rows a chunk of the per-frame attention


def conv(p, x, pad_hw: bool = True):
    """x [T, H, W, C]; w [kt, kh, kw, Cin, Cout]; SAME in H, W when pad_hw;
    VALID in time (the causal caller prepends frames)."""
    kh, kw = p["w"].shape[1:3]
    xc = x.permute(3, 0, 1, 2)[None]
    if pad_hw and (kh > 1 or kw > 1):
        xc = F.pad(xc, ((kw - 1) // 2, (kw - 1) // 2, (kh - 1) // 2, (kh - 1) // 2))
    y = F.conv3d(xc, p["w"].permute(4, 3, 0, 1, 2))
    return y[0].permute(1, 2, 3, 0) + p["b"]


def rms(p, x):
    c = x.shape[-1]
    return x / torch.clamp_min(x.norm(dim=-1, keepdim=True), 1e-12) * math.sqrt(c) * p["gamma"]


class WanVAEDecoderReference:
    """decode(z) for consecutive chunks of one stream."""

    def __init__(self, params, device):
        self.p = fp32_tree({k: params[k] for k in ("decoder", "conv2")})
        self.dev = device
        self.cache: Dict[str, torch.Tensor] = {}
        self.first = True

    def _slot(self):
        name = f"c{self._n}"
        self._n += 1
        return name

    def _pull(self, name, shape):
        if name in self.cache:
            return self.cache[name]
        return torch.zeros(shape, device=self.dev)

    def causal(self, p, x):
        kt = p["w"].shape[0]
        if kt == 1:
            return conv(p, x)
        name = self._slot()
        x_in = torch.cat([self._pull(name, (kt - 1,) + tuple(x.shape[1:])), x])
        self.cache[name] = x_in[-(kt - 1):]
        return conv(p, x_in)

    def res(self, p, x):
        h = conv(p["shortcut"], x) if "shortcut" in p else x
        y = self.causal(p["conv1"], F.silu(rms(p["norm1"], x)))
        y = self.causal(p["conv2"], F.silu(rms(p["norm2"], y)))
        return y + h

    def attn(self, p, x):
        t, h, w, c = x.shape
        qkv = conv(p["qkv"], rms(p["norm"], x)).reshape(t, h * w, 3, c)
        outs = []
        for f in range(t):
            q, k, v = qkv[f, :, 0], qkv[f, :, 1], qkv[f, :, 2]
            rows = [torch.softmax(q[r:r + ATTN_ROWS] @ k.T * c ** -0.5, dim=-1) @ v
                    for r in range(0, h * w, ATTN_ROWS)]
            outs.append(torch.cat(rows))
        return x + conv(p["proj"], torch.stack(outs).reshape(t, h, w, c))

    def upsample(self, p, x, mode: str):
        t, h, w, c = x.shape
        if mode == "upsample3d":
            name = self._slot()
            if not (self.first and t == 1):
                if self.first:
                    head, x_in = x[:1], torch.cat([x.new_zeros(2, h, w, c), x[1:]])
                else:
                    head, x_in = None, torch.cat([self._pull(name, (2, h, w, c)), x])
                self.cache[name] = x_in[-2:]
                tt = x_in.shape[0] - 2
                y = conv(p["time_conv"], x_in, pad_hw=False)
                y = y.reshape(tt, h, w, 2, c).permute(0, 3, 1, 2, 4).reshape(2 * tt, h, w, c)
                x = y if head is None else torch.cat([head, y])
        elif mode != "upsample2d":
            raise ValueError(f"unknown resample mode {mode!r}")
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv(p["conv"], x)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [T, h, w, 16] normalised latents of the stream's next chunk ->
        pixels [4T (or 4T - 3 for the stream's first chunk), 8h, 8w, 3],
        not clamped."""
        self._n = 0
        mean = torch.tensor(LATENT_MEAN, device=self.dev)
        std = torch.tensor(LATENT_STD, device=self.dev)
        d = self.p["decoder"]
        x = conv(self.p["conv2"], z.float() * std + mean)
        x = self.causal(d["conv1"], x)
        x = self.res(d["middle"]["res1"], x)
        x = self.attn(d["middle"]["attn"], x)
        x = self.res(d["middle"]["res2"], x)
        for blk in d["upsamples"]:
            (key,) = blk.keys()
            if key == "res":
                x = self.res(blk["res"], x)
            elif key == "attn":
                x = self.attn(blk["attn"], x)
            else:
                x = self.upsample(blk[key], x, key.split(":")[1])
        x = self.causal(d["head_conv"], F.silu(rms(d["head_norm"], x)))
        self.first = False
        return x
