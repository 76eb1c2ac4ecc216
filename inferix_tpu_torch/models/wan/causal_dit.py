"""Block-causal Wan DiT in PyTorch (port of
`inferix_tpu/models/wan/causal_dit.py`, the single-device branches, t2v and
i2v, bf16, W8A8 and fp8 weight-only, over a bf16, int8 or fp8 KV cache with a
global or rolling window, one start for the batch or one a stream).

Patch embedding, per-frame AdaLN time modulation, rope with a start-frame
offset, self-attention over the KV cache, cached text cross-attention (plus
the CLIP image tokens' cross-attention for i2v), the
GELU-tanh FFN, the modulated output head and unpatchify. Latents are
channels-last `[B, F, H, W, C]`; parameters keep the JAX tree with layers
stacked on a leading [L] axis (`utils/params.py`). fp32 promotion points
mirror the JAX package: time embeddings and modulation in fp32, norms
accumulate in fp32, attention softmax in fp32. A quantized tree
(`{"w_q", "scale", "b"}` linears from `quant.api.quantize_params`) runs every
block linear through a quantized GEMM: with int8 weights the int8 GEMM, the
three norm prologues and the other linears' inputs quantized by the fused
act-quant kernels; with e4m3 weights the fp8-dequant GEMM on the bf16
activations, after the plain norm chain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.config import ModelConfig
from ...kvcache.cache import (CrossAttnCache, KVCache, KVCacheSpec,
                              valid_mask, write_block)
from ...ops.attention import cache_attention
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import RopeTables, apply_rope, rope_angles, sinusoidal_embedding_1d
from ...quant.api import (adaln_quant, ln_quant, quantized_ffn,
                          quantized_linear, quantized_linear_prequant,
                          use_fused_prologue)

Params = Dict[str, Any]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b with w stored [in, out], in x's dtype; a quantized leaf
    ({"w_q", "scale", "b"}) goes through `quantized_linear`."""
    if "w_q" in p:
        return quantized_linear(p, x)
    return F.linear(x, p["w"].to(x.dtype).t(), p["b"].to(x.dtype))


def _cat_last(ts) -> torch.Tensor:
    """torch.cat on the last axis; e4m3 tensors through uint8 views (the
    bits carried as they are, on any device)."""
    if ts[0].dtype == torch.float8_e4m3fn:
        return torch.cat([t.view(torch.uint8) for t in ts], dim=-1).view(ts[0].dtype)
    return torch.cat(ts, dim=-1)


def fuse_qkv_params(params: Params) -> Params:
    """Merge the stacked self-attention q/k/v projections into one [D, 3D]
    projection (numerically identical: the output is split back before the
    q/k norms). Float leaves {"w", "b"} and quantized leaves
    {"w_q", "scale", "b"} alike; a per-tensor scale is broadcast to one per
    channel first, so the three scales concatenate. No-op if the tree is
    already fused."""
    blocks = params["blocks"]
    sa = blocks["self_attn"]
    if "qkv" in sa:
        return params
    parts = [sa[p] for p in ("q", "k", "v")]
    if "w" in parts[0]:
        names = ("w", "b")
    else:
        names = ("w_q", "scale", "b")
        parts = [{**p, "scale": p["scale"].expand(*p["scale"].shape[:-1],
                                                  p["w_q"].shape[-1])}
                 for p in parts]
    fused = {n: _cat_last([p[n] for p in parts]) for n in names}
    new_sa = {k: v for k, v in sa.items() if k not in ("q", "k", "v")}
    new_sa["qkv"] = fused
    return {**params, "blocks": {**blocks, "self_attn": new_sa}}


def layer_params(blocks: Params, layer: int) -> Params:
    """One layer's parameters: views `leaf[layer]` of the stacked tree."""
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in blocks.items()}


@dataclasses.dataclass(frozen=True)
class DiTGeometry:
    frames: int          # frames per forward call (block size)
    latent_h: int
    latent_w: int
    patch_size: Tuple[int, int, int]

    @property
    def grid_h(self) -> int:
        return self.latent_h // self.patch_size[1]

    @property
    def grid_w(self) -> int:
        return self.latent_w // self.patch_size[2]

    @property
    def frame_seq(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def tokens(self) -> int:
        return self.frames * self.frame_seq


def make_kv_spec(cfg: ModelConfig, batch: int, latent_h: int, latent_w: int,
                 dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                 kv_dtype: Optional[torch.dtype] = None) -> KVCacheSpec:
    """The self-attention cache of `cfg` (JAX `causal_dit.py:make_kv_spec`):
    a window of `attention_window_frames` frames, a ring with `sink_size`
    pinned frames when `local_attn_size != -1`, int8 K/V with scales when
    quantized, else `kv_dtype` (e.g. float8_e4m3fn) or the model dtype.
    Every pipeline write spans whole frames, so ring writes go granule by
    granule, one frame a granule."""
    frame_seq = DiTGeometry(1, latent_h, latent_w, cfg.patch_size).frame_seq
    return KVCacheSpec(
        num_layers=cfg.num_layers, batch=batch,
        max_tokens=cfg.attention_window_frames * frame_seq,
        num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
        sink_tokens=cfg.sink_size * frame_seq,
        ring=cfg.local_attn_size != -1,
        dtype=kv_dtype if kv_dtype is not None else dtype,
        quantized=quantized, granule=frame_seq)


def patch_embed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, C] -> tokens [B, F*gh*gw, dim], frame-major."""
    b, f, h, w, c = x.shape
    pt, ph, pw = cfg.patch_size
    assert f % pt == 0 and h % ph == 0 and w % pw == 0
    x = x.reshape(b, f // pt, pt, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = x.reshape(b, (f // pt) * (h // ph) * (w // pw), pt * ph * pw * c)
    return linear(params["patch_embedding"], x)


def unpatchify(x: torch.Tensor, cfg: ModelConfig, geo: DiTGeometry) -> torch.Tensor:
    """tokens [B, F*gh*gw, pt*ph*pw*out] -> [B, F, H, W, out]."""
    b = x.shape[0]
    pt, ph, pw = cfg.patch_size
    x = x.reshape(b, geo.frames // pt, geo.grid_h, geo.grid_w, pt, ph, pw,
                  cfg.out_dim)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, geo.frames, geo.latent_h, geo.latent_w, cfg.out_dim)


def time_embeddings(params: Params, cfg: ModelConfig,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t: [B, F] timesteps -> (e [B, F, dim], e0 [B, F, 6, dim]) fp32."""
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t.float())
    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], emb)))
    e0 = linear(params["time_projection"], F.silu(e))
    b, f = t.shape
    return e, e0.reshape(b, f, 6, cfg.dim)


def embed_text(params: Params, cfg: ModelConfig, context: torch.Tensor) -> torch.Tensor:
    """Text-encoder features [B, text_len, text_dim] -> [B, text_len, dim]."""
    te = params["text_embedding"]
    return linear(te["fc2"], F.gelu(linear(te["fc1"], context), approximate="tanh"))


def _project_kv(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                k: str, v: str, norm_k: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer's cross-attention K (RMS-normed) and V of `tokens`
    [B, s, dim]: [L, B, s, H, D] each."""
    b, s, _ = tokens.shape
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    ks, vs = [], []
    for lid in range(cfg.num_layers):
        ca = layer_params(params["blocks"]["cross_attn"], lid)
        ks.append(rms_norm(linear(ca[k], tokens), ca[norm_k]["w"], cfg.eps).reshape(shape))
        vs.append(linear(ca[v], tokens).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def embed_image(params: Params, cfg: ModelConfig,
                clip_features: torch.Tensor) -> torch.Tensor:
    """CLIP tokens [B, 257, 1280] -> [B, 257, dim] (the i2v `img_emb`
    MLPProj: LayerNorm, linear, erf GELU, linear, LayerNorm)."""
    ie = params["img_emb"]
    h = layer_norm(clip_features, ie["norm1"]["w"], ie["norm1"]["b"])
    h = F.gelu(linear(ie["fc1"], h))
    return layer_norm(linear(ie["fc2"], h), ie["norm2"]["w"], ie["norm2"]["b"])


def precompute_crossattn_cache(params: Params, cfg: ModelConfig,
                               context: torch.Tensor,
                               clip_features: Optional[torch.Tensor] = None
                               ) -> CrossAttnCache:
    """Project the text context through every layer's cross-attention K/V
    once per prompt: [L, B, text_len, H, D] each. For an i2v model,
    clip_features [B, 257, 1280] go through `img_emb` and each layer's
    k_img / v_img (the JAX package's `precompute_crossattn_cache`)."""
    k, v = _project_kv(params, cfg, embed_text(params, cfg, context), "k", "v", "norm_k")
    if cfg.model_type == "i2v" and clip_features is not None:
        # in the model's dtype (the JAX package computes img_emb in the
        # features' dtype, float32 from its CLIP tower)
        img = embed_image(params, cfg,
                          clip_features.to(params["img_emb"]["fc1"]["w"].dtype))
        k_img, v_img = _project_kv(params, cfg, img, "k_img", "v_img", "norm_k_img")
        return CrossAttnCache(k=k, v=v, k_img=k_img, v_img=v_img)
    return CrossAttnCache(k=k, v=v)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
              frames: int) -> torch.Tensor:
    """Per-frame AdaLN: x [B, S, C] with S = frames*frame_seq; shift/scale
    [B, F, C] fp32 broadcast over each frame's tokens, in x's dtype."""
    b, s, c = x.shape
    x = x.reshape(b, frames, s // frames, c)
    out = x * (1.0 + scale[:, :, None, :]).to(x.dtype) \
        + shift[:, :, None, :].to(x.dtype)
    return out.reshape(b, s, c)


def _gate(x: torch.Tensor, gate: torch.Tensor, frames: int) -> torch.Tensor:
    b, s, c = x.shape
    out = x.reshape(b, frames, s // frames, c) * gate[:, :, None, :].to(x.dtype)
    return out.reshape(b, s, c)


def block_forward(
    block: Params,
    cfg: ModelConfig,
    spec: KVCacheSpec,
    x: torch.Tensor,              # [B, S, C]
    e0: torch.Tensor,             # [B, F, 6, C] fp32
    angles: torch.Tensor,         # [S, head_dim//2]
    layer_cache: Tuple[torch.Tensor, ...],  # this layer's k, v [B, Smax, H, D]
                                            # (+ k_scale, v_scale [B, Smax, H])
    xattn_k: torch.Tensor,        # [B, text_len, H, D]
    xattn_v: torch.Tensor,
    current_start,                # token offset of this block (int or [B])
    kv_mask: torch.Tensor,        # [Smax] or [B, Smax] bool: valid slots after the write
    xattn_img: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # i2v image K/V
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One transformer layer. Writes the block's K/V into `layer_cache` in
    place (quantizing it for an int8 cache, whose layer_cache then holds the
    scales too), then attends over the cache's live slots. With int8 weights,
    each norm prologue (LN + modulate, or the norm3 LN) is fused with its
    linear's activation quantization."""
    b, s, c = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    frames = e0.shape[1]

    # modulation is per frame: six [B, F, C] fp32 vectors
    mod = block["modulation"][None] + e0
    shift_msa, scale_msa, gate_msa = mod[:, :, 0], mod[:, :, 1], mod[:, :, 2]
    shift_mlp, scale_mlp, gate_mlp = mod[:, :, 3], mod[:, :, 4], mod[:, :, 5]

    # --- self-attention over the KV cache ---
    sa = block["self_attn"]
    names = ("qkv",) if "qkv" in sa else ("q", "k", "v")
    if use_fused_prologue(sa[names[0]]):
        # fused LN + modulate + quant: the modulated bf16 tensor is never written
        h_q, h_s = adaln_quant(x, shift_msa, scale_msa, cfg.eps)
        proj = [quantized_linear_prequant(sa[n], h_q, h_s, x.dtype) for n in names]
    else:
        h_in = _modulate(layer_norm(x, eps=cfg.eps), shift_msa, scale_msa, frames)
        proj = [linear(sa[n], h_in) for n in names]
    q_p, k_p, v_p = proj[0].chunk(3, dim=-1) if len(proj) == 1 else proj
    # qk-norm: RMS over the whole width, before the head split and rope
    q = rms_norm(q_p, sa["norm_q"]["w"], cfg.eps)
    k = rms_norm(k_p, sa["norm_k"]["w"], cfg.eps)
    v = v_p.reshape(b, s, nh, hd)
    q = apply_rope(q.reshape(b, s, nh, hd), angles)
    k = apply_rope(k.reshape(b, s, nh, hd), angles)
    new_cache = write_block(spec, *layer_cache[:2], k, v, current_start,
                            *layer_cache[2:])
    scales = dict(k_scale=new_cache[2], v_scale=new_cache[3]) if spec.quantized else {}
    attn = cache_attention(q, new_cache[0], new_cache[1], kv_mask=kv_mask,
                           logical_kv=spec.max_tokens, **scales)
    x = x + _gate(linear(sa["o"], attn.reshape(b, s, c)), gate_msa, frames)

    # --- cross-attention over the cached text K/V ---
    ca = block["cross_attn"]
    w3, b3 = ((block["norm3"]["w"], block["norm3"]["b"]) if cfg.cross_attn_norm
              else (None, None))
    if use_fused_prologue(ca["q"]):
        hq2, hs2 = ln_quant(x.reshape(b * s, c), w3, b3, cfg.eps)
        cq = quantized_linear_prequant(ca["q"], hq2, hs2, x.dtype).reshape(b, s, c)
    else:
        cq = linear(ca["q"], layer_norm(x, w3, b3, cfg.eps))
    cq = rms_norm(cq, ca["norm_q"]["w"], cfg.eps)
    cq = cq.reshape(b, s, nh, hd)
    xa = cache_attention(cq, xattn_k, xattn_v)
    if xattn_img is not None:
        # i2v: the image attention is added to the text attention
        xa = xa + cache_attention(cq, *xattn_img)
    x = x + linear(ca["o"], xa.reshape(b, s, c))

    # --- FFN: fc2(gelu_tanh(fc1(h))); with int8 weights the gelu runs
    # inside fc2's quantization ---
    ffn = block["ffn"]
    if use_fused_prologue(ffn["fc1"]):
        hq3, hs3 = adaln_quant(x, shift_mlp, scale_mlp, cfg.eps)
        y = quantized_ffn(ffn["fc1"], ffn["fc2"], x_q=hq3, x_scale=hs3,
                          out_dtype=x.dtype)
    else:
        h_f = _modulate(layer_norm(x, eps=cfg.eps), shift_mlp, scale_mlp, frames)
        y = quantized_ffn(ffn["fc1"], ffn["fc2"], h_f)
    x = x + _gate(y, gate_mlp, frames)
    return x, new_cache


def head_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 e: torch.Tensor) -> torch.Tensor:
    """Output head with 2-way modulation; e: [B, F, C] fp32."""
    mod = params["head"]["modulation"][None, None] + e[:, :, None, :]
    h = _modulate(layer_norm(x, eps=cfg.eps), mod[:, :, 0], mod[:, :, 1],
                  e.shape[1])
    return linear(params["head"]["head"], h)


class DiTStatics(NamedTuple):
    cfg: ModelConfig
    spec: KVCacheSpec
    geo: DiTGeometry


def make_statics(cfg: ModelConfig, batch: int, frames: int, latent_h: int,
                 latent_w: int, dtype: torch.dtype = torch.bfloat16,
                 quantized_kv: bool = False,
                 kv_dtype: Optional[torch.dtype] = None) -> DiTStatics:
    return DiTStatics(cfg=cfg,
                      spec=make_kv_spec(cfg, batch, latent_h, latent_w, dtype,
                                        quantized_kv, kv_dtype),
                      geo=DiTGeometry(frames, latent_h, latent_w, cfg.patch_size))


def dit_forward_inference(
    params: Params,
    statics: DiTStatics,
    rope_tables: RopeTables,
    x: torch.Tensor,             # [B, F, H, W, C] noisy latents of this block
    t: torch.Tensor,             # [B, F] timesteps
    xattn: CrossAttnCache,
    cache: KVCache,              # [L, B, Smax, H, D] x2 (+ scales), updated in place
    current_start,               # token offset of the block: int, or [B] (one a stream)
    need_output: bool = True,
) -> Tuple[Optional[torch.Tensor], KVCache]:
    """One forward of the causal DiT over a block. Returns (flow
    [B, F, H, W, out_dim], cache).

    Every call writes the block's K/V into the cache slots of positions
    [current_start, current_start + tokens) of each layer (ring slots in a
    rolling window), in place. The JAX package's denoise steps run
    `persist_kv=False` and attend over a functional copy instead; the port
    needs no such mode, because each later denoise step and then the context
    re-run (or the persisting last step) rewrite the same slots, in every
    layer before that layer reads them, so each step attends over what the
    JAX step attends over (in a ring, with the same oldest tokens already
    overwritten) and the cache after a block is the same. need_output=False
    (the context re-run) skips the head and returns flow None.

    A [B] current_start (continuous batching: each stream at its own
    block) gives each row its rope offset, its cache write position and its
    live span; pass it as a CPU tensor, whose values the cache writes read
    without waiting for the card.
    """
    cfg, spec, geo = statics.cfg, statics.spec, statics.geo
    tokens = patch_embed(params, cfg, x)
    e, e0 = time_embeddings(params, cfg, t)
    if isinstance(current_start, torch.Tensor) and current_start.dim() == 1:
        current_start = current_start.to(torch.long)
    elif not isinstance(current_start, int):
        current_start = int(current_start)
    angles = rope_angles(rope_tables, geo.frames, geo.grid_h, geo.grid_w,
                         current_start // geo.frame_seq)
    kv_mask = valid_mask(spec, current_start + geo.tokens, device=x.device)
    fields = [f for f in cache if f is not None]
    h = tokens
    for lid in range(cfg.num_layers):
        img = (None if xattn.k_img is None
               else (xattn.k_img[lid], xattn.v_img[lid]))
        h, _ = block_forward(
            layer_params(params["blocks"], lid), cfg, spec, h, e0, angles,
            tuple(f[lid] for f in fields), xattn.k[lid], xattn.v[lid],
            current_start, kv_mask, xattn_img=img)
    if not need_output:
        return None, cache
    return unpatchify(head_forward(params, cfg, h, e), cfg, geo), cache
