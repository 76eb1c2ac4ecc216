"""CLIP vision tower for image-to-video conditioning (port of
`inferix_tpu/models/text/clip_vision.py`).

A ViT: patch embedding as a reshape and a matmul, a CLS token, learned
positional embeddings, pre-norm blocks and a final LayerNorm. Output
[B, 1 + (H/ps)*(W/ps), width] tokens (257 at 224/14), fed to
`precompute_crossattn_cache(..., clip_features=...)`. The MLP's GELU is the
tanh form (`jax.nn.gelu`'s default); attention logits are float32 from the
operands, scaled by head_dim^-0.5, with a float32 softmax.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...ops.norms import layer_norm
from ..wan.causal_dit import layer_params
from .umt5 import normal

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280        # ViT-H/14: the i2v img_emb's 1280 input
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return 1 + self.grid * self.grid  # 257 at 224/14


def tiny_clip_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4)


def init_clip_vision_params(cfg: CLIPVisionConfig, generator: torch.Generator,
                            device: str | torch.device = "cuda",
                            dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from the JAX package's distributions (not its
    bits): linear weights N(0, 1/in) [in, out] with zero biases, the CLS
    token and positions N(0, 0.02^2), LayerNorms 1 / 0 in float32. Blocks
    stacked on [layers]. `generator` must live on `device`."""
    dev = resolve_device(device)
    w, L = cfg.width, cfg.layers
    hidden = int(w * cfg.mlp_ratio)

    def lin(i, o, layers=()):
        return {"w": normal((*layers, i, o), i ** -0.5, generator, dtype, dev),
                "b": torch.zeros((*layers, o), dtype=dtype, device=dev)}

    def ln(*lead):
        return {"w": torch.ones((*lead, w), device=dev),
                "b": torch.zeros((*lead, w), device=dev)}

    return {
        "patch": lin(cfg.patch_size ** 2 * 3, w),
        "cls": normal((1, 1, w), 0.02, generator, dtype, dev),
        "pos": normal((1, cfg.num_tokens, w), 0.02, generator, dtype, dev),
        "ln_pre": ln(),
        "blocks": {"ln1": ln(L), "qkv": lin(w, 3 * w, (L,)), "proj": lin(w, w, (L,)),
                   "ln2": ln(L), "fc1": lin(w, hidden, (L,)), "fc2": lin(hidden, w, (L,))},
        "ln_post": ln(),
    }


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def clip_vision_encode(params: Params, cfg: CLIPVisionConfig,
                       image: torch.Tensor) -> torch.Tensor:
    """image: [B, H, W, 3] in [-1, 1] -> tokens [B, 1 + grid^2, width], in
    the image's dtype."""
    b, hh, ww, c = image.shape
    ps = cfg.patch_size
    x = image.reshape(b, hh // ps, ps, ww // ps, ps, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (hh // ps) * (ww // ps), ps * ps * c)
    x = _linear(params["patch"], x)
    cls = params["cls"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
    x = layer_norm(x, params["ln_pre"]["w"], params["ln_pre"]["b"])

    nh = cfg.heads
    hd = cfg.width // nh
    for i in range(cfg.layers):
        p = layer_params(params["blocks"], i)
        y = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
        qkv = _linear(p["qkv"], y).reshape(b, -1, 3, nh, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, -1, cfg.width)
        x = x + torch.matmul(o, p["proj"]["w"].to(o.dtype)) + p["proj"]["b"].to(o.dtype)
        y = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"])
        x = x + _linear(p["fc2"], F.gelu(_linear(p["fc1"], y), approximate="tanh"))
    return layer_norm(x, params["ln_post"]["w"], params["ln_post"]["b"])


class CLIPImageEncoder:
    """Image -> 257-token CLIP features for the i2v cross-attention branch."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            g = generator or torch.Generator(device=self.device).manual_seed(0)
            params = init_clip_vision_params(cfg, g, device=self.device)
        self.params = params

    @torch.inference_mode()
    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        if image.dim() == 3:
            image = image[None]
        return clip_vision_encode(self.params, self.cfg, image.to(self.device))
