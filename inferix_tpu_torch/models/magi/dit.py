"""MAGI-1 VideoDiT in PyTorch (port of `inferix_tpu/models/magi/dit.py`,
the single-device branches: bf16 / fp8-distill / W8A8 weights over a bf16,
e4m3 or int8 window cache).

The layer is the reference's PARALLEL attention design:

    ln   = LayerNorm(h)
    q    = rope(headLN(ln @ Wq)); k = rope(headLN(ln @ Wk)); v = ln @ Wv
    core = chunk-causal attention of q over the cached k/v (GQA)
    xatt = attention(headLN(ln @ Wqx), caption K/V)        (no rope)
    h1   = interleave_groups(core, xatt) @ Wproj           (float32 output)
    h    = PostNorm(h1 * g_msa[chunk]) + h                 (softcap gates)
    h    = PostNorm2(fc2(act(fc1(LayerNorm(h)))) * g_mlp[chunk]) + h
final: FinalLayerNorm(h.float()) @ Wfinal

All LayerNorms are zero-centered-gamma (weight = 1 + w) with bias. Rope uses
the learned frequency bands, rotate-half on the first 2*(3*hd//8) dims.

Attention goes through the GQA fold wherever the JAX package takes its
Pallas kernels on a TPU: self-attention per chunk over the cache
(`flash_attention_gqa`, or `flash_attention_gqa_quant` over the int8
cache), the prefix-free uncond forward, and the caption cross-attention
with each row's span the popcount of its (prefix) caption mask. On CUDA
tensors these launch the flash kernels; on CPU tensors the same fold runs
over their plain versions (the JAX package's CPU path repeats the K/V and
takes plain softmax attention: the same math in float32).

W8A8 linears ({"w_q" int8, "scale"}) quantize their input with the act-quant
kernel (gelu_exact or silu_mul folded into fc2's pass) and multiply with the
int8 GEMM, adding no bias: the JAX `magi_int8_linear` ignores "b" too.
The fp8 distill layout (e4m3 "w_q" with its scales) is plain ops, as in the
JAX package. With plain weights the joint projection returns float32: on
the card a bf16 x bf16 GEMM with a float32 output (`torch.mm(...,
out_dtype=torch.float32)`): its operands are bf16 values, so each product
is exact and the sums are float32, the JAX float32 dot's arithmetic, at the
bf16 rate; float operands elsewhere (the CPU tests) take a float32 matmul.

Not ported here: the mesh / sequence-parallel branches (`sp_mode` "cso" /
"ulysses") and `magi_forward_pp` (ROADMAP.md A13), the head-major and
padded cache layouts (A14c). `make_magi_statics` refuses them by name.
Where the JAX package threads an immutable cache, the port writes the
cache's buffers in place and returns the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.device import resolve_device
from ...kvcache.cache import KVCache, KVCacheSpec, write_block
from ...ops.act_quant import quantize_rows_int8
from ...ops.flash_attention import flash_attention_gqa, flash_attention_gqa_quant
from ...ops.norms import layer_norm
from ...quant.api import MAGI_BLOCK_KEYS
from ...quant.kernels import FP8, int8_matmul
from ..wan.causal_dit import layer_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MagiModelConfig:
    num_layers: int = 34
    hidden_size: int = 3072
    ffn_hidden_size: int = 12288
    num_attention_heads: int = 24
    num_query_groups: int = 8       # GQA kv heads
    kv_channels: int = 128          # head dim
    layernorm_epsilon: float = 1e-6
    apply_layernorm_1p: bool = True  # zero-centered gamma (weight = 1 + w)
    patch_size: int = 2
    t_patch_size: int = 1
    in_channels: int = 16
    out_channels: int = 16
    cond_hidden_ratio: float = 0.25
    xattn_cond_hidden_ratio: float = 1.0
    caption_channels: int = 4096
    caption_max_length: int = 800
    chunk_width: int = 6
    rope_max_seq_len: int = 1024
    x_rescale_factor: float = 1.0
    # 24B: SwiGLU MLP (fc1 -> 2*ffn, silu_and_mul) and 16-channel VAE
    # latents duplicated to the model's 32 input channels, the first 16
    # output channels kept
    gated_linear_unit: bool = False
    half_channel_vae: bool = False

    @property
    def cond_dim(self) -> int:
        return int(self.hidden_size * self.cond_hidden_ratio)

    @property
    def xattn_dim(self) -> int:
        return int(self.hidden_size * self.xattn_cond_hidden_ratio)

    @property
    def latent_channels(self) -> int:
        """Channels of the latents the pipeline manipulates (the VAE's z)."""
        return 16 if self.half_channel_vae else self.in_channels


def tiny_magi_config() -> MagiModelConfig:
    return MagiModelConfig(
        num_layers=2, hidden_size=128, ffn_hidden_size=256,
        num_attention_heads=4, num_query_groups=2, kv_channels=32,
        caption_channels=64, caption_max_length=8, chunk_width=2,
        rope_max_seq_len=64,
    )


@dataclasses.dataclass(frozen=True)
class MagiGeometry:
    latent_h: int
    latent_w: int
    chunk_width: int
    patch: int

    @property
    def grid_h(self) -> int:
        return self.latent_h // self.patch

    @property
    def grid_w(self) -> int:
        return self.latent_w // self.patch

    @property
    def frame_seq(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def chunk_tokens(self) -> int:
        return self.chunk_width * self.frame_seq


class MagiStatics(NamedTuple):
    cfg: MagiModelConfig
    spec: KVCacheSpec
    geo: MagiGeometry


def make_magi_statics(cfg: MagiModelConfig, batch: int, latent_h: int,
                      latent_w: int, max_chunks: int,
                      dtype: torch.dtype = torch.bfloat16, mesh=None,
                      sp_mode: str = "none",
                      kv_dtype: Optional[torch.dtype] = None,
                      quantize_kv: bool = False,
                      kv_head_major: bool = False,
                      kv_alloc_multiple: int = 0) -> MagiStatics:
    """The window cache of `max_chunks` chunks and the geometry. kv_dtype
    overrides the cache's storage dtype (torch.float8_e4m3fn: scale-free
    e4m3); quantize_kv=True selects the int8 cache with per-(token, head)
    scales. The mesh and `sp_mode` "cso" / "ulysses" (ROADMAP.md A13) and
    the TPU cache layouts `kv_head_major` / `kv_alloc_multiple` (A14c) are
    refused, never dropped."""
    if sp_mode not in ("none", "cso", "ulysses"):
        raise ValueError(f"MAGI sp_mode must be 'none', 'cso' or 'ulysses', "
                         f"got {sp_mode!r}")
    if mesh is not None or sp_mode != "none":
        raise NotImplementedError(
            f"mesh / sp_mode={sp_mode!r}: the parallel layer is not ported "
            f"(ROADMAP.md A13)")
    if kv_head_major or kv_alloc_multiple:
        raise NotImplementedError(
            "kv_head_major / kv_alloc_multiple: the head-major and padded "
            "cache layouts are not ported (ROADMAP.md A14c)")
    geo = MagiGeometry(latent_h, latent_w, cfg.chunk_width, cfg.patch_size)
    spec = KVCacheSpec(
        num_layers=cfg.num_layers, batch=batch,
        max_tokens=max_chunks * geo.chunk_tokens,
        num_kv_heads=cfg.num_query_groups, head_dim=cfg.kv_channels,
        dtype=kv_dtype if kv_dtype is not None else dtype,
        quantized=quantize_kv)
    return MagiStatics(cfg=cfg, spec=spec, geo=geo)


# ---------------------------------------------------------------------------
# Learned rope (LearnableRotaryEmbeddingCat)
# ---------------------------------------------------------------------------

def default_rope_bands(head_dim: int, temperature: float = 10000.0,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """freq_bands(num_bands=hd//8): 1/temp^(i/nb), the init the learned
    checkpoint bands replace."""
    nb = head_dim // 8
    exp = torch.arange(nb, dtype=torch.float32, device=resolve_device(device)) / nb
    return 1.0 / torch.pow(torch.tensor(temperature, device=exp.device), exp)


def magi_rope_angles(bands: torch.Tensor, t_total: int, grid_h: int,
                     grid_w: int) -> torch.Tensor:
    """Rotation angles [T*H*W, 3*nb] for the full (t_total, H, W) grid, on
    bands' device. Spatial coords are center-aligned and rescaled to the
    reference shape with rescale factor sqrt(H*W/256)."""
    rf = math.sqrt((grid_h * grid_w) / (16.0 * 16.0))
    dev = bands.device

    def axis_coords(n: int, centered: bool, ref: float) -> torch.Tensor:
        t = torch.arange(n, dtype=torch.float32, device=dev)
        if centered:
            t = t - (n - 1) / 2.0
        if n > 1 and abs(ref - n) > 1e-9:  # resize: x / (n-1) * (ref-1)
            t = t / (n - 1) * (ref - 1.0)
        return t

    tt = axis_coords(t_total, False, float(t_total))
    th = axis_coords(grid_h, True, grid_h / rf)
    tw = axis_coords(grid_w, True, grid_w / rf)
    grid = torch.stack(torch.meshgrid(tt, th, tw, indexing="ij"), dim=-1)
    pos = grid[..., None] * bands.float()          # [T, H, W, 3, nb]
    return pos.reshape(t_total * grid_h * grid_w, -1)


def apply_rope_magi(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope on the first 2*angles.shape[-1] dims of each head,
    the rest passed through. x: [..., S, H, D]; angles: [S, rot/2]."""
    half = angles.shape[-1]
    rot = 2 * half
    xf = x.float()
    x1, x2, tail = xf[..., :half], xf[..., half:rot], xf[..., rot:]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, tail],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _normal(generator: torch.Generator, dev: torch.device, i: int, o: int,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/i) weights [i, o], drawn in float32."""
    return (torch.randn(i, o, generator=generator, dtype=torch.float32, device=dev)
            * i ** -0.5).to(dtype)


def _ln_params(h: int, dtype: torch.dtype, dev: torch.device, layers=()) -> Params:
    """Zero-centered gamma: effective weight = 1 + w."""
    return {"w": torch.zeros(*layers, h, dtype=dtype, device=dev),
            "b": torch.zeros(*layers, h, dtype=dtype, device=dev)}


def _block_linears(cfg: MagiModelConfig) -> Tuple[Tuple[str, int, int, bool, bool], ...]:
    """(name, in, out, float32, bias) of a block's linears, in draw order."""
    h, hd = cfg.hidden_size, cfg.kv_channels
    q_dim, kv_dim = cfg.num_attention_heads * hd, cfg.num_query_groups * hd
    ffn1 = (2 if cfg.gated_linear_unit else 1) * cfg.ffn_hidden_size
    return (("q", h, q_dim, False, False), ("qx", h, q_dim, False, False),
            ("k", h, kv_dim, False, False), ("v", h, kv_dim, False, False),
            ("kv_xattn", cfg.xattn_dim, 2 * kv_dim, False, False),
            ("proj", 2 * q_dim, h, False, False),
            ("ada_proj", cfg.cond_dim, 2 * h, True, True),
            ("fc1", h, ffn1, False, False),
            ("fc2", cfg.ffn_hidden_size, h, False, False))


def init_magi_blocks(cfg: MagiModelConfig, generator: torch.Generator, layers: int,
                     device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.bfloat16) -> Params:
    """`layers` transformer blocks stacked on a leading [layers] axis, from
    the JAX `init_magi_block` distributions (not the same bits): linear
    weights N(0, 1/in) drawn in float32 a layer at a time into the stacked
    buffer (the float32 temporary is one layer's), no biases except
    ada_proj's (float32, zero), every LayerNorm zero (gamma 1), the post
    norms and ada_proj float32. `generator` must live on `device`."""
    dev = resolve_device(device)
    hd = cfg.kv_channels
    L = (layers,)
    out: Params = {
        "ln_qkv": _ln_params(cfg.hidden_size, dtype, dev, L),
        **{n: _ln_params(hd, dtype, dev, L) for n in ("q_ln", "qx_ln", "k_ln", "kx_ln")},
        "self_post_norm": _ln_params(cfg.hidden_size, torch.float32, dev, L),
        "mlp_post_norm": _ln_params(cfg.hidden_size, torch.float32, dev, L),
        "mlp_ln": _ln_params(cfg.hidden_size, dtype, dev, L),
    }
    for name, i, o, fp32, bias in _block_linears(cfg):
        dt = torch.float32 if fp32 else dtype
        w = torch.empty(layers, i, o, dtype=dt, device=dev)
        for layer in range(layers):
            w[layer] = _normal(generator, dev, i, o, dt)
        out[name] = {"w": w}
        if bias:
            out[name]["b"] = torch.zeros(layers, o, dtype=dt, device=dev)
    return out


def init_magi_params(cfg: MagiModelConfig, generator: torch.Generator,
                     device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.bfloat16,
                     layers: Optional[int] = None) -> Params:
    """Random MAGI parameters in the JAX tree's layout and dtypes (the
    `init_magi_params` distributions, not the same bits): `blocks` stacked
    over `layers` (default cfg.num_layers), the time embedder, the AdaLN
    caption projection, the final norm and the rope bands in float32, the
    rest in `dtype`. `generator` must live on `device`."""
    dev = resolve_device(device)
    h, cond = cfg.hidden_size, cfg.cond_dim
    patch_in = cfg.t_patch_size * cfg.patch_size ** 2 * cfg.in_channels
    patch_out = cfg.t_patch_size * cfg.patch_size ** 2 * cfg.out_channels
    f32 = torch.float32

    def lin(i, o, dt, bias=True):
        p = {"w": _normal(generator, dev, i, o, dt)}
        if bias:
            p["b"] = torch.zeros(o, dtype=dt, device=dev)
        return p

    params = {
        "blocks": init_magi_blocks(cfg, generator, layers or cfg.num_layers, dev, dtype),
        "x_embedder": lin(patch_in, h, dtype, bias=False),
        "t_embedder": {"fc1": lin(256, cond, f32), "fc2": lin(cond, cond, f32)},
        "y_embedder": {
            "y_proj_xattn": lin(cfg.caption_channels, cfg.xattn_dim, dtype),
            "y_proj_adaln": lin(cfg.caption_channels, cond, f32),
            "null_caption_embedding": (torch.randn(
                cfg.caption_max_length, cfg.caption_channels, generator=generator,
                dtype=f32, device=dev) * 0.02).to(dtype),
        },
        "rope_bands": default_rope_bands(cfg.kv_channels, device=dev),
        "final_layernorm": _ln_params(h, f32, dev),
        "final_linear": lin(h, patch_out, dtype, bias=False),
    }
    return params


# ---------------------------------------------------------------------------
# Linears (plain / fp8-distill / W8A8)
# ---------------------------------------------------------------------------

_E4M3_MAX = 448.0


def _qdq_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize through float8_e4m3fn (div_clamp_to fidelity):
    clipped to +-448 first, since the cast does not saturate."""
    return x.clamp(-_E4M3_MAX, _E4M3_MAX).to(FP8).to(x.dtype)


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    """silu in float32 as the act-quant kernel's silu_mul computes it
    (x * sigmoid(x)), so the split fc1 layout is bit-equal to the folded."""
    xf = x.float()
    return xf * torch.sigmoid(xf)


def split_gated_fc1(params: Params, ffn_hidden_size: int) -> Params:
    """Every block's gated fc1 from the concatenated [h, gate|up] layout into
    separate leaves ("fc1" -> gate, "fc1_up" -> up), as views. Splits any
    fc1 leaf whose last dim is 2*ffn (w / w_q / per-channel scale);
    input-dim or scalar leaves (act_scale, smooth_scale, input_scale) are
    shared by both halves. The same math as the concatenated layout."""
    def split_block(blk):
        if "fc1" not in blk or "fc1_up" in blk:
            return blk
        gate, up = {}, {}
        for name, leaf in blk["fc1"].items():
            if leaf.dim() >= 1 and leaf.shape[-1] == 2 * ffn_hidden_size:
                gate[name] = leaf[..., :ffn_hidden_size]
                up[name] = leaf[..., ffn_hidden_size:]
            else:
                gate[name] = up[name] = leaf
        return {**blk, "fc1": gate, "fc1_up": up}

    out = dict(params)
    for key in MAGI_BLOCK_KEYS:
        if key in out:
            out[key] = split_block(out[key])
    return out


def magi_int8_linear(p: Params, x: torch.Tensor,
                     act: Optional[str] = None) -> torch.Tensor:
    """W8A8 linear: the act-quant kernel (the optional activation folded
    into its pass) then the int8 GEMM, f32 accumulate x per-token scale x
    per-channel scale, cast to x's dtype. No bias, as in the JAX package."""
    *lead, k = x.shape
    x_q, x_scale = quantize_rows_int8(x.reshape(-1, k), act=act)
    out = int8_matmul(x_q, p["w_q"], x_scale, p["scale"], out_dtype=x.dtype)
    return out.reshape(*lead, out.shape[-1])


def magi_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Plain / fp8 distill-quant / int8 W8A8 linear. fp8 params: e4m3 w_q
    [in, out], a scalar weight_scale, and act_scale [in] (per-tensor:
    clamp x / act_scale to e4m3, scale back) or smooth_scale [in] + a
    scalar input_scale (per-channel); the weight dequantized each call."""
    if "w_q" in p:
        if p["w_q"].dtype == torch.int8:
            return magi_int8_linear(p, x)
        xf = x.float()
        if "smooth_scale" in p:
            xq = _qdq_e4m3(xf / p["smooth_scale"]) * p["input_scale"]
        else:
            xq = _qdq_e4m3(xf / p["act_scale"]) * p["act_scale"]
        w = p["w_q"].float() * p["weight_scale"]
        return xq.to(x.dtype) @ w.to(x.dtype)
    out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


def _linear_f32_out(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) with a float32 output, the JAX `magi_linear(p,
    x.astype(float32))`: bf16 x and w on the card through a GEMM with a
    float32 output (exact products, float32 sums); float32 matmul else."""
    w = p["w"]
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        out = out.reshape(*x.shape[:-1], out.shape[-1])
    else:
        out = x.float() @ w.float()
    if "b" in p:
        out = out + p["b"].float()
    return out


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm(x, 1.0 + p["w"].float(), p["b"].float(), eps)


def _softcap(x: torch.Tensor, cap: float = 1.0) -> torch.Tensor:
    return cap * torch.tanh(x.float() / cap)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

def _patchify(cfg: MagiModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, W, C] -> [B, T*gh*gw, patch_in], (ph, pw, C) order."""
    b, t, hh, ww, c = x.shape
    p = cfg.patch_size
    x = x.reshape(b, t, hh // p, p, ww // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (hh // p) * (ww // p), p * p * c)


def _unpatchify(cfg: MagiModelConfig, geo: MagiGeometry, x: torch.Tensor,
                t: int) -> torch.Tensor:
    b, p = x.shape[0], cfg.patch_size
    x = x.reshape(b, t, geo.grid_h, geo.grid_w, p, p, cfg.out_channels)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, geo.latent_h, geo.latent_w, cfg.out_channels)


def _postprocess_velocity(cfg: MagiModelConfig, geo: MagiGeometry,
                          out: torch.Tensor, t: int) -> torch.Tensor:
    """Unpatchify, keep the first 16 channels for the half-channel VAE, undo
    x_rescale."""
    velocity = _unpatchify(cfg, geo, out, t)
    if cfg.half_channel_vae:
        velocity = velocity[..., :16]
    if cfg.x_rescale_factor != 1.0:
        velocity = velocity / cfg.x_rescale_factor
    return velocity


def _xattn_attend(cq: torch.Tensor, yk: torch.Tensor, yv: torch.Tensor,
                  cmask: torch.Tensor) -> torch.Tensor:
    """Caption cross-attention through the GQA fold (no repeated K/V). The
    caption masks are prefix masks (valid tokens, then padding), so each
    row's span end is its popcount, reduced on the device."""
    kv_len = cmask.sum(dim=1, dtype=torch.int32)   # [B*nc]
    return flash_attention_gqa(cq, yk, yv, kv_len=kv_len)


def _int_pairs(x) -> list:
    """[n, 2] chunk ranges (numpy, list or tensor) as Python int pairs."""
    return [(int(a), int(b)) for a, b in torch.as_tensor(x).reshape(-1, 2).tolist()]


def _magi_layer(
    blk: Params,
    h_x: torch.Tensor,            # [B, n_chunks*ct, hidden]
    cond: torch.Tensor,           # [B, n_chunks, cond_dim] f32
    y: torch.Tensor,              # [B, n_chunks, cap_len, xattn_dim]
    caption_mask: torch.Tensor,   # [B, n_chunks, cap_len]
    layer_cache: Optional[tuple],  # this layer's (k, v[, k_scale, v_scale])
    *,
    cfg: MagiModelConfig,
    spec: KVCacheSpec,
    n_chunks: int,
    ct: int,
    angles: torch.Tensor,         # [n_chunks*ct, 3*nb]
    token_ranges: Optional[list] = None,   # [(start, end)] tokens, a chunk
    current_start: Optional[int] = None,
    current_end: Optional[int] = None,
) -> torch.Tensor:
    """One MAGI transformer layer; writes the window's K/V into
    `layer_cache` in place (layer_cache None: the prefix-free branch, each
    batch row a lone chunk attending only to itself). Returns h_x."""
    b = h_x.shape[0]
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_query_groups, cfg.kv_channels
    rep = nh // nkv
    eps = cfg.layernorm_epsilon
    dt = h_x.dtype

    residual = h_x
    ln = _ln(blk["ln_qkv"], h_x, eps)

    # self attention: q/k head-LN in float32, then rope
    q = magi_linear(blk["q"], ln).reshape(b, -1, nh, hd)
    q = apply_rope_magi(_ln(blk["q_ln"], q.float(), eps), angles).to(dt)
    k = magi_linear(blk["k"], ln).reshape(b, -1, nkv, hd)
    k = apply_rope_magi(_ln(blk["k_ln"], k.float(), eps), angles).to(dt)
    v = magi_linear(blk["v"], ln).reshape(b, -1, nkv, hd)

    if layer_cache is None:
        core = flash_attention_gqa(q, k, v, kv_len=k.shape[1])
    else:
        fields = write_block(spec, layer_cache[0], layer_cache[1], k, v,
                             current_start, *(layer_cache[2:] if spec.quantized else ()))
        outs = []
        for ci in range(n_chunks):
            qi = q[:, ci * ct:(ci + 1) * ct]
            start, end = token_ranges[ci]
            kv_len = min(end, current_end)
            if spec.quantized:
                outs.append(flash_attention_gqa_quant(qi, *fields, kv_len=kv_len,
                                                      kv_start=start))
            else:
                outs.append(flash_attention_gqa(qi, *fields, kv_len=kv_len,
                                                kv_start=start))
        core = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]

    # cross attention (parallel branch, same ln input)
    qx = magi_linear(blk["qx"], ln).reshape(b, -1, nh, hd)
    qx = _ln(blk["qx_ln"], qx.float(), eps).to(dt)
    # caption K/V [.., 2*kv_dim] group-major [g0_k|g0_v|g1_k|...]; V stays a
    # strided view of it
    cap_len = y.shape[2]
    kv_y = magi_linear(blk["kv_xattn"], y).reshape(b, n_chunks, cap_len, nkv, 2 * hd)
    yk = _ln(blk["kx_ln"], kv_y[..., :hd].float(), eps).to(dt)
    yv = kv_y[..., hd:].to(dt)
    xa = _xattn_attend(qx.reshape(b * n_chunks, ct, nh, hd),
                       yk.reshape(b * n_chunks, cap_len, nkv, hd),
                       yv.reshape(b * n_chunks, cap_len, nkv, hd),
                       caption_mask.reshape(b * n_chunks, cap_len) > 0)
    xatt = xa.reshape(b, n_chunks * ct, nh, hd)

    # joint projection with the (n=2, hn=nkv) group interleave
    cat = torch.stack([core.reshape(b, -1, nkv, rep * hd),
                       xatt.reshape(b, -1, nkv, rep * hd)], dim=3)
    cat = cat.reshape(b, -1, 2 * nkv * rep * hd)
    if "w" in blk["proj"]:
        h1 = _linear_f32_out(blk["proj"], cat)
    else:
        h1 = magi_linear(blk["proj"], cat.to(dt))

    # softcap gates + post-norm residuals
    gates = _softcap(magi_linear(blk["ada_proj"], F.silu(cond.float())), 1.0)
    g_msa, g_mlp = gates[..., :cfg.hidden_size], gates[..., cfg.hidden_size:]

    def bias_modulate_add(xv, res, gate, post_norm):
        xf = xv.float().reshape(b, n_chunks, ct, -1) * gate[:, :, None, :]
        xf = _ln(post_norm, xf.reshape(b, n_chunks * ct, -1), eps)
        return (xf + res.float()).to(dt)

    h_x = bias_modulate_add(h1, residual, g_msa, blk["self_post_norm"])

    residual = h_x
    mlp_in = _ln(blk["mlp_ln"], h_x, eps)
    fc2 = blk["fc2"]
    if "fc1_up" in blk:
        # gate/up-separate layout (split_gated_fc1)
        gate = magi_linear(blk["fc1"], mlp_in)
        up = magi_linear(blk["fc1_up"], mlp_in)
        ff = magi_linear(fc2, _silu_f32(gate).to(up.dtype) * up)
    else:
        ff_in = magi_linear(blk["fc1"], mlp_in)
        if "w_q" in fc2 and fc2["w_q"].dtype == torch.int8:
            # the activation folded into fc2's quantization pass
            ff = magi_int8_linear(fc2, ff_in, act="silu_mul" if cfg.gated_linear_unit
                                  else "gelu_exact")
        else:
            if cfg.gated_linear_unit:
                d = cfg.ffn_hidden_size
                act = _silu_f32(ff_in[..., :d]).to(ff_in.dtype) * ff_in[..., d:]
            else:
                act = F.gelu(ff_in, approximate="none")
            ff = magi_linear(fc2, act)
    return bias_modulate_add(ff, residual, g_mlp, blk["mlp_post_norm"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _timestep_embedding_256(t: torch.Tensor) -> torch.Tensor:
    """TimestepEmbedder.timestep_embedding: dim 256, rescale 1000,
    [cos | sin]."""
    half = 128
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _t_embed(te: Params, t: torch.Tensor) -> torch.Tensor:
    return magi_linear(te["fc2"], F.silu(magi_linear(te["fc1"], _timestep_embedding_256(t))))


def _embed_window_inputs(params: Params, statics: MagiStatics, x_window: torch.Tensor,
                         t: torch.Tensor, captions: torch.Tensor, slice_point: int,
                         caption_dropout: Optional[torch.Tensor],
                         distill_dt_factor: Optional[float]):
    """Patch tokens, the AdaLN condition (t-embed + each row's null-caption
    adaln token: [-1] when caption_dropout, else [-2]; + t_embedder(dt) for
    distilled checkpoints), the projected captions, and the window's slice
    of the rope angles over the cache's temporal extent."""
    cfg, spec, geo = statics
    b, n_chunks = t.shape
    ct = geo.chunk_tokens

    if cfg.x_rescale_factor != 1.0:
        x_window = x_window * cfg.x_rescale_factor
    if cfg.half_channel_vae:
        if x_window.shape[-1] != 16:
            raise ValueError(f"half_channel_vae takes 16-channel latents, got "
                             f"{x_window.shape[-1]}")
        x_window = torch.cat([x_window, x_window], dim=-1)
    tokens = magi_linear(params["x_embedder"], _patchify(cfg, x_window))
    te = params["t_embedder"]
    cvec = _t_embed(te, t)
    if distill_dt_factor is not None:
        cvec = cvec + _t_embed(te, torch.full_like(t, distill_dt_factor))
    ye = params["y_embedder"]
    null_cond = ye["null_caption_embedding"][-2].float()
    null_drop = ye["null_caption_embedding"][-1].float()
    if caption_dropout is None:
        tok = null_cond[None].expand(b, -1)
    else:
        tok = torch.where(caption_dropout.to(null_cond.device)[:, None],
                          null_drop[None], null_cond[None])
    y_adaln = magi_linear(ye["y_proj_adaln"], tok)          # [B, cond_dim]
    cond = (cvec + y_adaln[:, None, :]).float()
    y = F.silu(magi_linear(ye["y_proj_xattn"], captions.to(tokens.dtype)))

    max_t = spec.max_tokens // geo.frame_seq
    full = magi_rope_angles(params["rope_bands"], max_t, geo.grid_h, geo.grid_w)
    size = n_chunks * ct
    start = min(max(slice_point * ct, 0), full.shape[0] - size)  # clamped, as JAX's slice
    return tokens, cond, y, full[start:start + size]


def _layers(params: Params, num_layers: int) -> Iterator[Tuple[int, Params]]:
    """(layer index, its params) for the `blocks` layout, or the fp8
    layout's `blocks_first`, stacked `blocks_mid` and `blocks_last`."""
    if "blocks" in params:
        for layer in range(num_layers):
            yield layer, layer_params(params["blocks"], layer)
        return
    yield 0, params["blocks_first"]
    for i in range(num_layers - 2):
        yield i + 1, layer_params(params["blocks_mid"], i)
    yield num_layers - 1, params["blocks_last"]


def _head(params: Params, cfg: MagiModelConfig, geo: MagiGeometry,
          h_x: torch.Tensor, frames: int) -> torch.Tensor:
    """Final LayerNorm in float32 + the plain output linear, unpatchified."""
    h_out = _ln(params["final_layernorm"], h_x.float(), cfg.layernorm_epsilon)
    return _postprocess_velocity(cfg, geo, magi_linear(params["final_linear"], h_out),
                                 frames)


def sync_cache_rows(spec: KVCacheSpec, cache: KVCache, start: int, length: int,
                    src_row: int = 1, dst_row: int = 0) -> KVCache:
    """Copy the token span [start, start+length) of batch row `src_row` into
    `dst_row` for every layer and field, in place (the 3-CFG cache: only
    the cond_pre row's KV persists). Returns the same cache."""
    for f in cache:
        if f is not None:
            f[:, dst_row, start:start + length].copy_(f[:, src_row, start:start + length])
    return cache


def magi_forward(
    params: Params,
    statics: MagiStatics,
    rope_tables,                     # unused (learned bands in params)
    x_window: torch.Tensor,          # [B, n_chunks*chunk_width, H, W, C]
    t,                               # [B, n_chunks] in [0, 1] (0=noise, 1=clean)
    captions: torch.Tensor,          # [B, n_chunks, cap_len, cap_dim]
    caption_mask: torch.Tensor,      # [B, n_chunks, cap_len]
    cache: KVCache,
    slice_point: int,                # chunk index of window chunk 0
    kv_ranges,                       # [n_chunks, 2] chunk ranges [start, end)
    max_chunks: Optional[int] = None,
    distill_dt_factor: Optional[float] = None,
    caption_dropout: Optional[torch.Tensor] = None,  # [B] bool
    sync_kv_rows: bool = False,
    static_kv_spans=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One window forward. Every window chunk's K/V is written into the
    cache at its position (in place); chunk i attends to the tokens
    [kv_ranges[i, 0] * ct, kv_ranges[i, 1] * ct). Returns (velocity
    [B, n_chunks*cw, H, W, out] float32, the cache). sync_kv_rows=True (the
    3-CFG batch, B=2): afterwards row 1's span overwrites row 0's
    (`sync_cache_rows`). static_kv_spans sizes the TPU's kernel grid; the
    CUDA kernels walk only each span, so it has no effect here."""
    del rope_tables, max_chunks, static_kv_spans
    cfg, spec, geo = statics
    dev = x_window.device
    t = torch.as_tensor(t, device=dev, dtype=torch.float32)
    b, n_chunks = t.shape
    cw, ct = geo.chunk_width, geo.chunk_tokens
    slice_point = int(slice_point)

    h_x, cond, y, angles = _embed_window_inputs(
        params, statics, x_window, t, captions, slice_point, caption_dropout,
        distill_dt_factor)
    caption_mask = torch.as_tensor(caption_mask, device=dev)
    current_start = slice_point * ct
    current_end = current_start + n_chunks * ct
    token_ranges = [(s * ct, e * ct) for s, e in _int_pairs(kv_ranges)]
    fields = tuple(f for f in cache if f is not None)
    for layer, blk in _layers(params, cfg.num_layers):
        h_x = _magi_layer(
            blk, h_x, cond, y, caption_mask, tuple(f[layer] for f in fields),
            cfg=cfg, spec=spec, n_chunks=n_chunks, ct=ct, angles=angles,
            token_ranges=token_ranges, current_start=current_start,
            current_end=current_end)
    velocity = _head(params, cfg, geo, h_x, n_chunks * cw)
    if sync_kv_rows:
        if b != 2:
            raise ValueError("sync_kv_rows is the 3-CFG batched-forward contract (B=2)")
        sync_cache_rows(spec, cache, current_start, n_chunks * ct)
    return velocity, cache


def magi_forward_window_scan(
    params: Params,
    statics: MagiStatics,
    rope_tables,
    x_window: torch.Tensor,          # [B, n_chunks*chunk_width, H, W, C]
    t,                               # [B, n_chunks]
    captions: torch.Tensor,          # [B, n_chunks, cap_len, cap_dim]
    caption_mask: torch.Tensor,
    cache: KVCache,
    slice_point: int,
    kv_ranges,                       # [n_chunks, 2]
    caption_dropout: Optional[torch.Tensor] = None,
    distill_dt_factor: Optional[float] = None,
    static_kv_spans=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Per-chunk window dispatch: one `magi_forward` a chunk, in order,
    chained through the cache (chunk i's kv range covers only chunks <= i,
    whose K/V earlier iterations wrote). The same math as the whole-window
    forward with one chunk's activations live; the JAX package runs it as a
    `lax.scan`. No sync_kv_rows: the caller syncs the window's span once
    afterwards."""
    del static_kv_spans
    dev = x_window.device
    t = torch.as_tensor(t, device=dev, dtype=torch.float32)
    caption_mask = torch.as_tensor(caption_mask, device=dev)
    ranges = _int_pairs(kv_ranges)
    cw = statics.geo.chunk_width
    vels = []
    for ci in range(t.shape[1]):
        v, cache = magi_forward(
            params, statics, rope_tables, x_window[:, ci * cw:(ci + 1) * cw],
            t[:, ci:ci + 1], captions[:, ci:ci + 1], caption_mask[:, ci:ci + 1], cache,
            int(slice_point) + ci, [ranges[ci]], caption_dropout=caption_dropout,
            distill_dt_factor=distill_dt_factor)
        vels.append(v)
    return torch.cat(vels, dim=1), cache


def magi_forward_uncond(
    params: Params,
    statics: MagiStatics,
    x_chunks: torch.Tensor,      # [n_den, chunk_width, H, W, C] per-chunk rows
    t,                           # [n_den, 1]
    captions: torch.Tensor,      # [n_den, 1, cap_len, cap_dim] (null caption)
    caption_mask: torch.Tensor,  # [n_den, 1, cap_len]
    distill_dt_factor: Optional[float] = None,
) -> torch.Tensor:
    """The 3-CFG third forward: every denoising chunk is its own batch row,
    attends only to itself (no cache read or write), rope restarts at
    position 0 and the caption is dropped (adaln null token -1). Returns
    velocity [n_den, chunk_width, H, W, out]."""
    cfg, spec, geo = statics
    dev = x_chunks.device
    t = torch.as_tensor(t, device=dev, dtype=torch.float32)
    b = x_chunks.shape[0]
    h_x, cond, y, angles = _embed_window_inputs(
        params, statics, x_chunks, t, captions, 0,
        torch.ones(b, dtype=torch.bool, device=dev), distill_dt_factor)
    caption_mask = torch.as_tensor(caption_mask, device=dev)
    for _, blk in _layers(params, cfg.num_layers):
        h_x = _magi_layer(blk, h_x, cond, y, caption_mask, None, cfg=cfg, spec=spec,
                          n_chunks=1, ct=geo.chunk_tokens, angles=angles)
    return _head(params, cfg, geo, h_x, geo.chunk_width)
