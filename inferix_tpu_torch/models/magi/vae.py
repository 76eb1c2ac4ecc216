"""MAGI ViT-VAE in PyTorch (port of `inferix_tpu/models/magi/vae.py`).

A 3D-patch ViT encoder -> DiagonalGaussian latent -> ViT decoder, laid out
so that the reference MAGI VAE checkpoints load through
`utils.checkpoint.convert_magi_vae_state_dict`:

* learnable positional embeddings [num_patches + cls, D] with a trilinear
  resize (torch's `align_corners=False`, no antialias) when the input
  geometry differs from the pretrain geometry, and a prepended cls token;
* 3D rotary embeddings on q/k of every token but the cls: step-1 frequency
  bands, the temporal axis uncentered and the spatial axes centered,
  rescaled to `rope_ref_feat_shape`, sin/cos repeated pairwise and an
  INTERLEAVED rotation;
* `ln_in_attn`: no pre-norm before attention; instead a LayerNorm without
  affine over the head dim of the packed qkv, `(x - mean) / (std + eps)`
  with the BIASED std and eps added to the std;
* the decoder's final linear + LayerNorm, unpatchify, and a 3x3x3 conv to
  RGB.

Channels-last throughout; the stacked blocks run in a Python loop.

Attention (`vit_attention`): bf16 (or the run's dtype) q . k with float32
logits and softmax, the probabilities cast to v's dtype before PV, as the
JAX einsum chain computes it. Its head dim is 768 / 16 = 48, which the
port's flash kernel (D = 128) does not take, and the JAX package runs no
Pallas kernel here. On the card it is PyTorch's
`scaled_dot_product_attention` pinned through `sdpa_kernel` to the flash
backend (the efficient backend for float32), which never builds the
[B, H, S, S] logits: one decoded MAGI-4.5B chunk has S = 48601 tokens, whose
float32 logits would take 151 GB. A backend that cannot take the call
raises; there is no fallback to the math backend. On CPU tensors the plain
einsum chain runs, VIT_PLAIN_ROWS query rows at a time.

Compute dtype: each linear casts its weight to the activations' dtype, as
the JAX `_linear` does, so a call runs in its input's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...ops.norms import layer_norm
from ..wan.causal_dit import layer_params

Params = Dict[str, Any]

# Query rows a step of the plain attention (the rows are independent).
VIT_PLAIN_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class ViTVAEConfig:
    """Mirrors the reference ddconfig (checkpoint `config.json`)."""

    video_size: int = 256       # pretrain geometry (pos-embed table shape)
    video_length: int = 16
    patch_size: int = 8
    patch_length: int = 4
    in_chans: int = 3
    z_chans: int = 16
    double_z: bool = True
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 16         # head_dim must be divisible by 6 for rope
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    with_cls_token: bool = True
    ln_in_attn: bool = True
    use_rope: bool = True
    use_final_proj: bool = True
    norm_code: bool = False
    rope_ref_feat_shape: Tuple[int, int, int] = (4, 16, 16)
    scale_factor: float = 0.18215  # latent scaling (runtime_config)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def latent_size(self) -> int:
        return self.video_size // self.patch_size

    @property
    def latent_length(self) -> int:
        return self.video_length // self.patch_length

    @property
    def num_patches(self) -> int:
        return self.latent_length * self.latent_size * self.latent_size

    @property
    def cls_token_nums(self) -> int:
        return 1 if self.with_cls_token else 0

    @property
    def unpatch_channels(self) -> int:
        vol = self.patch_size * self.patch_size * self.patch_length
        return 4 if self.use_final_proj else self.embed_dim // vol


def tiny_vitvae_config() -> ViTVAEConfig:
    return ViTVAEConfig(video_size=16, video_length=4, patch_size=4,
                        patch_length=2, embed_dim=48, depth=2, num_heads=2,
                        z_chans=4)


# ---------------------------------------------------------------------------
# Rotary tables (host-side numpy)
# ---------------------------------------------------------------------------

def vitvae_rope_tables(feat_shape: Tuple[int, int, int], head_dim: int,
                       ref_feat_shape: Tuple[int, int, int],
                       temperature: float = 10000.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos) [S, 6*nb] float32 for the (T, H, W) grid: step-1 bands,
    the temporal axis uncentered and the spatial axes centered, the eva
    rescale `t = x / f * r`, each value repeated twice."""
    nb = head_dim // (len(feat_shape) * 2)
    assert nb > 0, f"head_dim {head_dim} too small for 3-axis rope"
    exp = np.arange(nb, dtype=np.float64) / nb
    bands = 1.0 / (temperature ** exp)

    axes = []
    for i, (s, r) in enumerate(zip(feat_shape, ref_feat_shape)):
        t = np.arange(s, dtype=np.float64)
        if i != 0:
            t = t - (s - 1) / 2.0
        t = t / s * r
        axes.append(t)
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    pos = grid[..., None] * bands                     # [T, H, W, 3, nb]
    pos = pos.reshape(-1, 3 * nb)
    sin = np.repeat(np.sin(pos), 2, axis=-1)
    cos = np.repeat(np.cos(pos), 2, axis=-1)
    return sin.astype(np.float32), cos.astype(np.float32)


def _apply_rot_interleaved(x: torch.Tensor, sin: torch.Tensor,
                           cos: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D]; sin/cos [S, rot] with rot <= D (interleaved
    pairs). Dims past rot pass through. float32 math, x's dtype out."""
    rot = sin.shape[-1]
    xf = x.float()
    xr, tail = xf[..., :rot], xf[..., rot:]
    pairs = xr.reshape(*xr.shape[:-1], rot // 2, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xr.shape)
    out = xr * cos[:, None, :] + rotated * sin[:, None, :]
    return torch.cat([out, tail], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_vitvae_params(cfg: ViTVAEConfig, generator: torch.Generator,
                       device: str | torch.device = "cuda") -> Params:
    """Random ViT-VAE parameters in the JAX tree's layout (the
    `init_vitvae_params` distributions, not the same bits): linear weights
    N(0, 1/in) with zero biases, LayerNorms at (1, 0), the pos-embed table
    and cls token N(0, 0.02^2), the last conv N(0, 1/(27 * C_in)); blocks
    stacked on a leading [depth] axis; float32, as in the JAX package.
    `generator` must live on `device`."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    pin = cfg.patch_length * cfg.patch_size ** 2 * cfg.in_chans
    zc = cfg.z_chans * (2 if cfg.double_z else 1)
    n_tok = cfg.num_patches + cfg.cls_token_nums
    vol = cfg.patch_length * cfg.patch_size ** 2
    hidden = int(d * cfg.mlp_ratio)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=generator, device=dev) * std

    def lin(i, o, bias=True, layers=()):
        p = {"w": randn(*layers, i, o, std=i ** -0.5)}
        if bias:
            p["b"] = torch.zeros(*layers, o, device=dev)
        return p

    def ln(n, layers=()):
        return {"w": torch.ones(*layers, n, device=dev),
                "b": torch.zeros(*layers, n, device=dev)}

    def tower(first, last):
        L = (cfg.depth,)
        blocks = {"qkv": lin(d, 3 * d, bias=cfg.qkv_bias, layers=L),
                  "proj": lin(d, d, layers=L), "norm2": ln(d, L),
                  "fc1": lin(d, hidden, layers=L), "fc2": lin(hidden, d, layers=L)}
        if not cfg.ln_in_attn:
            blocks["norm1"] = ln(d, L)
        t = {**first, "pos_embed": randn(n_tok, d, std=0.02), "blocks": blocks,
             "norm": ln(d), **last}
        if cfg.with_cls_token:
            t["cls_token"] = randn(d, std=0.02)
        return t

    enc = tower({"patch": lin(pin, d)}, {"last": lin(d, zc)})
    uc = cfg.unpatch_channels
    dec_last = {"last_conv": {"w": randn(3, 3, 3, uc, 3, std=(27 * uc) ** -0.5),
                              "b": torch.zeros(3, device=dev)}}
    if cfg.use_final_proj:
        dec_last["final_proj"] = lin(d, uc * vol)
        dec_last["final_norm"] = ln(uc * vol)
    dec = tower({"proj_in": lin(cfg.z_chans, d)}, dec_last)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def _ln(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return layer_norm(x, p["w"].float(), p["b"].float(), eps)


def _manual_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / (std + eps), BIASED std, eps on the std, no affine;
    float32 out."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    std = (xf - mean).square().mean(-1, keepdim=True).sqrt()
    return (xf - mean) / (std + eps)


def vit_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """The JAX einsum chain: q, k, v [B, S, H, D]; float32 logits scaled by
    D^-0.5, float32 softmax, the probabilities cast to v's dtype, PV in v's
    dtype. Returns [B, Sq, H, D]. VIT_PLAIN_ROWS query rows at a time."""
    scale = q.shape[-1] ** -0.5
    kf = k.float().permute(0, 2, 3, 1)                 # [B, H, D, S]
    vv = v.permute(0, 2, 1, 3)                         # [B, H, S, D]
    outs = []
    for r in range(0, q.shape[1], VIT_PLAIN_ROWS):
        qr = q[:, r:r + VIT_PLAIN_ROWS].float().permute(0, 2, 1, 3)
        probs = torch.softmax((qr @ kf) * scale, dim=-1).to(v.dtype)
        outs.append((probs @ vv).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The ViT-VAE's attention, [B, S, H, D] in and out. CUDA tensors:
    `scaled_dot_product_attention` pinned to the flash backend (bf16 /
    fp16) or the efficient backend (float32), either of which raises
    rather than falling back; CPU tensors: `vit_attention_reference`."""
    if not q.is_cuda:
        return vit_attention_reference(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = (SDPBackend.EFFICIENT_ATTENTION if q.dtype == torch.float32
               else SDPBackend.FLASH_ATTENTION)
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2))
    return out.transpose(1, 2)


def _vit_block(p: Params, x: torch.Tensor, cfg: ViTVAEConfig,
               sin: Optional[torch.Tensor], cos: Optional[torch.Tensor]) -> torch.Tensor:
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    h = x if cfg.ln_in_attn else _ln(p["norm1"], x)
    qkv = _linear(p["qkv"], h).reshape(b, s, 3, nh, hd)
    if cfg.ln_in_attn:
        qkv = _manual_ln(qkv).to(x.dtype)
    q, k, v = qkv.unbind(2)
    if cfg.use_rope:
        n = cfg.cls_token_nums
        q = torch.cat([q[:, :n], _apply_rot_interleaved(q[:, n:], sin, cos)], dim=1)
        k = torch.cat([k[:, :n], _apply_rot_interleaved(k[:, n:], sin, cos)], dim=1)
    o = vit_attention(q, k, v).reshape(b, s, d)
    x = x + _linear(p["proj"], o)
    h = _ln(p["norm2"], x)
    return x + _linear(p["fc2"], F.gelu(_linear(p["fc1"], h), approximate="none"))


def _linear_resample_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """torch F.interpolate(mode='*linear', align_corners=False,
    antialias=False) along one axis: half-pixel source coords, clamped,
    2-tap linear interpolation."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    coords = ((torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5)
              * (in_size / out_size) - 0.5).clamp(0.0, in_size - 1)
    lo = torch.floor(coords).long()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    w = coords - lo.float()
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w.reshape(shape)
    return x.index_select(axis, lo) * (1.0 - w) + x.index_select(axis, hi) * w


def _pos_embed_for(cfg: ViTVAEConfig, pos: torch.Tensor,
                   feat_shape: Tuple[int, int, int]) -> torch.Tensor:
    """The learnable table, trilinear-resized in float32 when the geometry
    differs from the pretrain geometry; the cls row kept verbatim."""
    src = (cfg.latent_length, cfg.latent_size, cfg.latent_size)
    n = cfg.cls_token_nums
    if tuple(feat_shape) == src:
        return pos
    grid = pos[n:].reshape(*src, cfg.embed_dim).float()
    for ax, size in enumerate(feat_shape):
        grid = _linear_resample_axis(grid, ax, size)
    return torch.cat([pos[:n], grid.reshape(-1, cfg.embed_dim).to(pos.dtype)], dim=0)


def _run_tower(p: Params, cfg: ViTVAEConfig, tokens: torch.Tensor,
               feat_shape: Tuple[int, int, int]) -> torch.Tensor:
    """cls prepend + pos embed + the block stack + final norm. tokens:
    [B, S, D]; returns the patch tokens (cls dropped)."""
    b = tokens.shape[0]
    if cfg.with_cls_token:
        cls = p["cls_token"].to(tokens.dtype)[None, None].expand(b, 1, cfg.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + _pos_embed_for(cfg, p["pos_embed"], feat_shape).to(tokens.dtype)[None]
    sin = cos = None
    if cfg.use_rope:
        sin_np, cos_np = vitvae_rope_tables(feat_shape, cfg.head_dim, cfg.rope_ref_feat_shape)
        sin = torch.from_numpy(sin_np).to(tokens.device)
        cos = torch.from_numpy(cos_np).to(tokens.device)
    for i in range(cfg.depth):
        tokens = _vit_block(layer_params(p["blocks"], i), tokens, cfg, sin, cos)
    tokens = _ln(p["norm"], tokens)
    return tokens[:, cfg.cls_token_nums:]


def _conv3d_same(p: Params, x: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv, channels-last in and out (w in DHWIO)."""
    w = p["w"].to(x.dtype).permute(4, 3, 0, 1, 2)     # -> [O, I, kd, kh, kw]
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, p["b"].to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 4, 1)


class ViTVAE:
    """The MAGI ViT-VAE: encode [B, T, H, W, 3] in [-1, 1] to latents
    [B, T/pl, H/ps, W/ps, z] and decode them back.

    params: the JAX package's tree (e.g. through
    `utils.params.params_from_numpy` or `convert_magi_vae_state_dict`), or
    None to draw one (`init_vitvae_params`) from `generator` (default: a
    generator on `device` seeded 0). A call computes in its input's dtype."""

    def __init__(self, cfg: ViTVAEConfig = ViTVAEConfig(), params: Optional[Params] = None,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        if cfg.use_rope:
            assert cfg.head_dim % 6 == 0, (
                f"use_rope needs head_dim divisible by 6 (3 axes x "
                f"interleaved pairs), got {cfg.head_dim}")
        self.device = resolve_device(device)
        if params is None:
            g = generator or torch.Generator(device=self.device).manual_seed(0)
            params = init_vitvae_params(cfg, g, self.device)
        self.params = params

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def encode_moments(self, video) -> torch.Tensor:
        """Raw encoder output [B, gt, gh, gw, 2z] (mean | logvar) before
        scale_factor: the DiagonalGaussianDistribution parameters."""
        cfg = self.cfg
        x = self._input(video)
        b, t, hh, ww, c = x.shape
        pl, ps = cfg.patch_length, cfg.patch_size
        gt, gh, gw = t // pl, hh // ps, ww // ps
        # conv-as-matmul patch embed: feature order (c, pl, ph, pw), the
        # Conv3d weight layout [D, C, pl, ph, pw] flattened
        xp = x.reshape(b, gt, pl, gh, ps, gw, ps, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        xp = xp.reshape(b, gt * gh * gw, c * pl * ps * ps)
        enc = self.params["encoder"]
        h = _run_tower(enc, cfg, _linear(enc["patch"], xp), (gt, gh, gw))
        out = _linear(enc["last"], h).reshape(b, gt, gh, gw, -1)
        if cfg.norm_code:
            outf = out.float()
            out = (outf / torch.linalg.vector_norm(outf, dim=-1, keepdim=True)).to(out.dtype)
        return out

    def _draw_eps(self, generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
        """The posterior sample's noise: the one random draw of the VAE."""
        return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                           device=self.device).to(dtype)

    @torch.inference_mode()
    def encode(self, video, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1]; T == 1 is repeated to
        patch_length frames and the first latent frame kept (the reference's
        single-image path). With a generator, a posterior sample
        (mean + std * eps); otherwise the mode. Scaled by scale_factor."""
        video = self._input(video)
        if video.shape[1] == 1 and self.cfg.patch_length > 1:
            video = video.expand(video.shape[0], self.cfg.patch_length, *video.shape[2:])
            return self.encode(video, generator)[:, :1]
        mo = self.encode_moments(video)
        z = self.cfg.z_chans
        mean = mo[..., :z]
        if generator is None:
            return mean * self.cfg.scale_factor
        logvar = mo[..., z:].clamp(-30.0, 20.0)
        std = torch.exp(0.5 * logvar)
        eps = self._draw_eps(generator, mean.shape, mean.dtype)
        return (mean + std * eps) * self.cfg.scale_factor

    @torch.inference_mode()
    def _decode(self, latents) -> torch.Tensor:
        """Latents [B, gt, gh, gw, z] -> pixels [B, gt*pl, gh*ps, gw*ps, 3],
        not clipped."""
        cfg = self.cfg
        z = self._input(latents)
        b, gt, gh, gw, zc = z.shape
        pl, ps = cfg.patch_length, cfg.patch_size
        dec = self.params["decoder"]
        z = z / cfg.scale_factor
        h = _linear(dec["proj_in"], z.reshape(b, gt * gh * gw, zc))
        h = _run_tower(dec, cfg, h, (gt, gh, gw))
        if cfg.use_final_proj:
            h = _ln(dec["final_norm"], _linear(dec["final_proj"], h))
        uc = cfg.unpatch_channels
        out = h.reshape(b, gt, gh, gw, pl, ps, ps, uc).permute(0, 1, 4, 2, 5, 3, 6, 7)
        out = out.reshape(b, gt * pl, gh * ps, gw * ps, uc)
        return _conv3d_same(dec["last_conv"], out)

    def decode(self, latents) -> torch.Tensor:
        """Pixels in [-1, 1]."""
        return self._decode(latents).clamp(-1.0, 1.0)
