"""Block-causal Wan DiT in PyTorch (port of
`inferix_tpu/models/wan/causal_dit.py`: t2v and i2v, bf16, W8A8 and fp8
weight-only, over a bf16, int8 or fp8 KV cache, token-major or head-major,
padded or not, with a global or rolling window, one start for the batch or
one a stream; on one device or, with a mesh, sequence parallel).

Patch embedding, per-frame AdaLN time modulation, rope with a start-frame
offset, self-attention over the KV cache, cached text cross-attention (plus
the CLIP image tokens' cross-attention for i2v), the
GELU-tanh FFN, the modulated output head and unpatchify; and the three
whole-clip forwards (bidirectional, block-causal, teacher forcing) over a
clip-sized cache. Latents are
channels-last `[B, F, H, W, C]`; parameters keep the JAX tree with layers
stacked on a leading [L] axis (`utils/params.py`). fp32 promotion points
mirror the JAX package: time embeddings and modulation in fp32, norms
accumulate in fp32, attention softmax in fp32. A quantized tree
(`{"w_q", "scale", "b"}` linears from `quant.api.quantize_params`) runs every
block linear through a quantized GEMM: with int8 weights the int8 GEMM, the
three norm prologues and the other linears' inputs quantized by the fused
act-quant kernels; with e4m3 weights the fp8-dequant GEMM on the bf16
activations, after the plain norm chain.

With a mesh of sp > 1 ranks and an `sp_mode` (`DiTStatics`), each rank runs
the layers on its frame shard of the block's tokens (`parallel/mesh.py`),
and self-attention writes and reads the rank's shard of the cache through
the mode's island (`parallel/distributed_attention.py`); the output head's
tokens are gathered, so every rank returns the whole flow. With tp > 1 each
rank holds its tp shard of the tree (`parallel.mesh.wan_param_shards`):
q / k / v and fc1 give the rank's heads and hidden columns, o and fc2 sum
the ranks' partials, the qk-norms reduce their sums of squares, and the
text / image K/V hold the rank's heads (`parallel/tensor_parallel.py`).
With pp > 1 and no island (`DiTStatics.pp`) the forward is a GPipe
pipeline (`parallel/pipeline_parallel.py`, the JAX branch of the same
condition): the rank holds its stage's layers of the tree, of the text /
image K/V and of the cache, the batch rows are the microbatches, and every
stage ends with the whole output (at tp > 1 inside a stage, the stage's
layers run on the rank's tp shard). With pp > 1 and an island the JAX
package does not pipeline either: it runs the island over the whole stack,
and so do the port's pp ranks, each holding every layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.config import ModelConfig
from ...kvcache.cache import (CrossAttnCache, KVCache, KVCacheSpec,
                              init_kv_cache, padded_tokens, valid_mask, write_block)
from ...ops.attention import cache_attention
from ...ops.norms import layer_norm
from ...ops.rope import RopeTables, apply_rope, rope_angles, sinusoidal_embedding_1d
from ...ops.row_norm import ln_rows, qk_rows_take, rms_rows, rope_cos_sin, rows_take
from ...parallel.distributed_attention import sp_cache_attention, sp_write_block
from ...parallel.mesh import (CacheShard, Mesh, SPMesh, as_mesh, frame_shard,
                              gather_frame_shards, wan_kv_cache_shard)
from ...parallel.pipeline_parallel import pp_pipeline
from ...parallel.tensor_parallel import rms_norm_tp, rms_norms_tp, row_linear
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
                 kv_dtype: Optional[torch.dtype] = None, head_major: bool = False,
                 alloc_multiple: int = 0) -> KVCacheSpec:
    """The self-attention cache of `cfg` (JAX `causal_dit.py:make_kv_spec`):
    a window of `attention_window_frames` frames, a ring with `sink_size`
    pinned frames when `local_attn_size != -1`, int8 K/V with scales when
    quantized, else `kv_dtype` (e.g. float8_e4m3fn) or the model dtype;
    stored head-major with head_major, its slots padded up to a multiple of
    alloc_multiple (0: not padded)."""
    frame_seq = DiTGeometry(1, latent_h, latent_w, cfg.patch_size).frame_seq
    max_tokens = cfg.attention_window_frames * frame_seq
    return KVCacheSpec(
        num_layers=cfg.num_layers, batch=batch, max_tokens=max_tokens,
        num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
        sink_tokens=cfg.sink_size * frame_seq,
        ring=cfg.local_attn_size != -1,
        dtype=kv_dtype if kv_dtype is not None else dtype,
        quantized=quantized, head_major=head_major,
        alloc_tokens=padded_tokens(max_tokens, alloc_multiple))


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
                k: str, v: str, norm_k: str, tp: Optional[SPMesh] = None,
                sharded: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer's cross-attention K (RMS-normed) and V of `tokens`
    [B, s, dim]: [L, B, s, H, D] each, or with tp the rank's H / tp heads:
    from its column shard of k / v (sharded), or from replicated weights
    (the i2v k_img / v_img) whose heads are sliced after the norm."""
    b, s, _ = tokens.shape
    heads = cfg.num_heads // tp.size if tp is not None and sharded else cfg.num_heads
    shape = (b, s, heads, cfg.head_dim)
    ks, vs = [], []
    # the tree's layers: all of them, or a pipeline stage's
    layers = next(iter(params["blocks"]["cross_attn"][k].values())).shape[0]
    for lid in range(layers):
        ca = layer_params(params["blocks"]["cross_attn"], lid)
        kn = rms_norm_tp(tp if sharded else None, linear(ca[k], tokens), ca[norm_k]["w"],
                         cfg.eps, cfg.dim)
        ks.append(kn.reshape(shape))
        vs.append(linear(ca[v], tokens).reshape(shape))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if tp is not None and not sharded:
        per = cfg.num_heads // tp.size
        ks, vs = (x[:, :, :, tp.rank * per:(tp.rank + 1) * per] for x in (ks, vs))
    return ks, vs


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
                               clip_features: Optional[torch.Tensor] = None,
                               tp: Optional[SPMesh] = None) -> CrossAttnCache:
    """Project the text context through every layer's cross-attention K/V
    once per prompt: [L, B, text_len, H, D] each. For an i2v model,
    clip_features [B, 257, 1280] go through `img_emb` and each layer's
    k_img / v_img (the JAX package's `precompute_crossattn_cache`). With tp
    (a group of more than one rank) `params` is the rank's tp shard and the
    K/V hold its H / tp heads (the JAX `xattn_cache_pspec`)."""
    tp = tp if tp is not None and tp.size > 1 else None
    k, v = _project_kv(params, cfg, embed_text(params, cfg, context), "k", "v", "norm_k",
                       tp)
    if cfg.model_type == "i2v" and clip_features is not None:
        # in the model's dtype (the JAX package computes img_emb in the
        # features' dtype, float32 from its CLIP tower)
        img = embed_image(params, cfg,
                          clip_features.to(params["img_emb"]["fc1"]["w"].dtype))
        k_img, v_img = _project_kv(params, cfg, img, "k_img", "v_img", "norm_k_img", tp,
                                   sharded=False)
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
    kv_mask: Optional[torch.Tensor],  # [Smax] or [B, Smax] bool: valid slots after the write
    xattn_img: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # i2v image K/V
    sp: Optional["SPContext"] = None,  # sequence parallel: x is a frame shard
    tp: Optional[SPMesh] = None,  # tensor parallel: block is the rank's tp shard
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cos, sin of angles
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One transformer layer. Writes the block's K/V into `layer_cache` in
    place (quantizing it for an int8 cache, whose layer_cache then holds the
    scales too), then attends over the cache's live slots. With int8 weights,
    each norm prologue (LN + modulate, or the norm3 LN) is fused with its
    linear's activation quantization. On a CUDA bf16 x the row kernels
    (`ops/row_norm.py`) run the other norm chains: LN + modulate and the
    norm3 LN, and at tp 1 the q / k RMS norms with the rope (from `rope`,
    the cos / sin tables of angles, taken here when None) and the cross q's
    RMS norm. With `sp`, x holds this rank's frame
    shard of the tokens and layer_cache its shard of the cache: the write
    and the attention go through the sp island (kv_mask unused). With `tp`,
    block holds the rank's tp shard: its H / tp heads attend over its heads
    of the cache and of the text K/V, and o / fc2 reduce over tp."""
    b, s, c = x.shape
    hd = cfg.head_dim
    nh = cfg.num_heads // tp.size if tp is not None else cfg.num_heads
    c_loc = nh * hd
    frames = e0.shape[1]

    def out_linear(p: Params, h: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        """o / fc2: row-parallel over tp (act: fc2's folded gelu), else plain."""
        return row_linear(tp, p, h, act) if tp is not None else linear(p, h)

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
    elif rows_take(x):
        h_in = ln_rows(x, cfg.eps, shift=shift_msa, scale=scale_msa)
        proj = [linear(sa[n], h_in) for n in names]
    else:
        h_in = _modulate(layer_norm(x, eps=cfg.eps), shift_msa, scale_msa, frames)
        proj = [linear(sa[n], h_in) for n in names]
    q_p, k_p, v_p = proj[0].chunk(3, dim=-1) if len(proj) == 1 else proj
    v = v_p.reshape(b, s, nh, hd)
    # qk-norm: RMS over the whole width, before the head split and rope
    wq, wk = sa["norm_q"]["w"], sa["norm_k"]["w"]
    if (tp is None or tp.size == 1) and qk_rows_take(q_p, k_p, hd, wq, wk):
        q, k = rms_rows((q_p, k_p), (wq, wk), cfg.eps,
                        rope if rope is not None else rope_cos_sin(angles), hd)
        q, k = q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd)
    else:
        q, k = rms_norms_tp(tp, (q_p, k_p), (wq, wk), cfg.eps, cfg.dim)
        q = apply_rope(q.reshape(b, s, nh, hd), angles)
        k = apply_rope(k.reshape(b, s, nh, hd), angles)
    if sp is not None:
        new_cache = sp_write_block(sp.mesh, sp.mode, spec, sp.shard, layer_cache, k, v,
                                   current_start, frames)
        attn = sp_cache_attention(sp.mesh, sp.mode, spec, sp.shard, q, new_cache,
                                  sp.current_end, frames)
    else:
        new_cache = write_block(spec, *layer_cache[:2], k, v, current_start,
                                *layer_cache[2:])
        scales = dict(k_scale=new_cache[2], v_scale=new_cache[3]) if spec.quantized else {}
        attn = cache_attention(q, new_cache[0], new_cache[1], kv_mask=kv_mask,
                               logical_kv=spec.max_tokens,
                               kv_layout="bhsd" if spec.head_major else "bshd", **scales)
    x = x + _gate(out_linear(sa["o"], attn.reshape(b, s, c_loc)), gate_msa, frames)

    # --- cross-attention over the cached text K/V ---
    ca = block["cross_attn"]
    w3, b3 = ((block["norm3"]["w"], block["norm3"]["b"]) if cfg.cross_attn_norm
              else (None, None))
    if use_fused_prologue(ca["q"]):
        hq2, hs2 = ln_quant(x.reshape(b * s, c), w3, b3, cfg.eps)
        cq = quantized_linear_prequant(ca["q"], hq2, hs2, x.dtype).reshape(b, s, c_loc)
    elif rows_take(x, w3, b3):
        cq = linear(ca["q"], ln_rows(x, cfg.eps, w3, b3))
    else:
        cq = linear(ca["q"], layer_norm(x, w3, b3, cfg.eps))
    wcq = ca["norm_q"]["w"]
    if (tp is None or tp.size == 1) and rows_take(cq, wcq):
        cq = rms_rows((cq,), (wcq,), cfg.eps)[0]
    else:
        cq = rms_norm_tp(tp, cq, wcq, cfg.eps, cfg.dim)
    cq = cq.reshape(b, s, nh, hd)
    xa = cache_attention(cq, xattn_k, xattn_v)
    if xattn_img is not None:
        # i2v: the image attention is added to the text attention
        xa = xa + cache_attention(cq, *xattn_img)
    x = x + out_linear(ca["o"], xa.reshape(b, s, c_loc))

    # --- FFN: fc2(gelu_tanh(fc1(h))); with int8 weights the gelu runs
    # inside fc2's quantization ---
    ffn = block["ffn"]
    if use_fused_prologue(ffn["fc1"]):
        hq3, hs3 = adaln_quant(x, shift_mlp, scale_mlp, cfg.eps)
        if tp is not None:
            y = out_linear(ffn["fc2"], quantized_linear_prequant(ffn["fc1"], hq3, hs3,
                                                                 x.dtype), "gelu")
        else:
            y = quantized_ffn(ffn["fc1"], ffn["fc2"], x_q=hq3, x_scale=hs3,
                              out_dtype=x.dtype)
    else:
        h_f = (ln_rows(x, cfg.eps, shift=shift_mlp, scale=scale_mlp) if rows_take(x)
               else _modulate(layer_norm(x, eps=cfg.eps), shift_mlp, scale_mlp, frames))
        if tp is not None:
            y = out_linear(ffn["fc2"], linear(ffn["fc1"], h_f), "gelu")
        else:
            y = quantized_ffn(ffn["fc1"], ffn["fc2"], h_f)
    x = x + _gate(y, gate_mlp, frames)
    return x, new_cache


def head_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 e: torch.Tensor) -> torch.Tensor:
    """Output head with 2-way modulation; e: [B, F, C] fp32. On a CUDA bf16
    x the LN + modulate is one row kernel (`ops.row_norm.ln_rows`)."""
    mod = params["head"]["modulation"][None, None] + e[:, :, None, :]
    if rows_take(x):
        h = ln_rows(x, cfg.eps, shift=mod[:, :, 0], scale=mod[:, :, 1])
    else:
        h = _modulate(layer_norm(x, eps=cfg.eps), mod[:, :, 0], mod[:, :, 1],
                      e.shape[1])
    return linear(params["head"]["head"], h)


class DiTStatics(NamedTuple):
    """Host-side constants of the forward. With a mesh and a mode of
    `parallel.distributed_attention.MODES` the forward runs its attention
    in that island over the mesh's sp group; `tp` is the mesh's tp group
    when it has more than one rank; `shard` is this rank's cache shard;
    `pp` is the mesh's pp group when the forward is a pipeline (pp > 1, no
    island): the spec then counts the stage's layers."""

    cfg: ModelConfig
    spec: KVCacheSpec
    geo: DiTGeometry
    mesh: Optional[Mesh] = None
    sp_mode: str = "none"
    shard: CacheShard = CacheShard("none", 0, 0)
    tp: Optional[SPMesh] = None
    pp: Optional[SPMesh] = None


class SPContext(NamedTuple):
    """What a layer's sp island reads besides the statics."""

    mesh: SPMesh
    mode: str
    shard: CacheShard
    current_end: Any      # the block's end position: int, or [B] CPU tensor


def make_statics(cfg: ModelConfig, batch: int, frames: int, latent_h: int,
                 latent_w: int, dtype: torch.dtype = torch.bfloat16,
                 quantized_kv: bool = False,
                 kv_dtype: Optional[torch.dtype] = None, mesh=None,
                 sp_mode: str = "none", kv_head_major: bool = False,
                 kv_alloc_multiple: int = 0) -> DiTStatics:
    """batch: the rows this rank runs (B / dp). mesh: a `Mesh` (or an
    `SPMesh`, a mesh of sp ranks). The island runs for a mode on a mesh of
    sp > 1, and for "ulysses" on a tp-only mesh too (its sp all-to-alls
    are then identities); else the single-device attention, over the
    rank's heads at tp > 1. A mesh of pp > 1 without an island pipelines
    the layers (the caller holds its stage's layers of the tree,
    `parallel.pipeline_parallel.stage_layers`); L % pp != 0 raises
    ValueError, as the JAX package asserts."""
    spec = make_kv_spec(cfg, batch, latent_h, latent_w, dtype, quantized_kv, kv_dtype,
                        head_major=kv_head_major, alloc_multiple=kv_alloc_multiple)
    geo = DiTGeometry(frames, latent_h, latent_w, cfg.patch_size)
    mesh = as_mesh(mesh)
    if mesh is None:
        return DiTStatics(cfg=cfg, spec=spec, geo=geo)
    tp = mesh.tp if mesh.tp.size > 1 else None
    if tp is not None:
        for what, n in (("heads", cfg.num_heads), ("ffn columns", cfg.ffn_dim)):
            if n % tp.size:
                raise ValueError(f"{n} {what} do not split over tp {tp.size}")
    if mesh.sp.size == 1 and not (tp is not None and sp_mode == "ulysses"):
        sp_mode = "none"
    if sp_mode != "none" and geo.frame_seq % mesh.sp.size:
        raise ValueError(f"{geo.frame_seq} tokens a frame do not split over sp "
                         f"{mesh.sp.size}")
    pp = mesh.pp if mesh.pp.size > 1 and sp_mode == "none" else None
    if pp is not None:
        if cfg.num_layers % pp.size:
            raise ValueError(f"{cfg.num_layers} layers do not split over pp {pp.size}")
        spec = dataclasses.replace(spec, num_layers=cfg.num_layers // pp.size)
    return DiTStatics(cfg=cfg, spec=spec, geo=geo, mesh=mesh, sp_mode=sp_mode,
                      shard=wan_kv_cache_shard(sp_mode, spec, mesh), tp=tp, pp=pp)


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
    current_end = current_start + geo.tokens
    sp = kv_mask = None
    if statics.sp_mode != "none":
        # this rank's frame shard of the tokens and of their rope angles
        mesh = statics.mesh.sp
        tokens = frame_shard(mesh, tokens, geo.frames)
        angles = frame_shard(mesh, angles, geo.frames, dim=angles.dim() - 2)
        sp = SPContext(mesh, statics.sp_mode, statics.shard,
                       current_end if isinstance(current_end, int) else current_end.cpu())
    else:
        kv_mask = valid_mask(spec, current_end, device=x.device)
    # the rope's cos / sin tables, once a forward, where the layers' q / k row
    # kernel can take them (tp 1, a CUDA bf16 stream)
    rope = rope_cos_sin(angles) if statics.tp is None and rows_take(tokens) else None
    fields = [f for f in cache if f is not None]
    if statics.pp is not None:
        return _pipelined_forward(params, statics, tokens, e, e0, angles, xattn, fields,
                                  current_start, kv_mask, need_output, rope), cache
    h = tokens
    for lid in range(cfg.num_layers):
        img = (None if xattn.k_img is None
               else (xattn.k_img[lid], xattn.v_img[lid]))
        h, _ = block_forward(
            layer_params(params["blocks"], lid), cfg, spec, h, e0, angles,
            tuple(f[lid] for f in fields), xattn.k[lid], xattn.v[lid],
            current_start, kv_mask, xattn_img=img, sp=sp, tp=statics.tp, rope=rope)
    if not need_output:
        return None, cache
    out = head_forward(params, cfg, h, e)
    if sp is not None:
        out = gather_frame_shards(sp.mesh, out, geo.frames)
    return unpatchify(out, cfg, geo), cache


def _pipelined_forward(params: Params, statics: DiTStatics, tokens: torch.Tensor,
                       e: torch.Tensor, e0: torch.Tensor, angles: torch.Tensor,
                       xattn: CrossAttnCache, fields, current_start, kv_mask,
                       need_output: bool,
                       rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Optional[torch.Tensor]:
    """The layers through the stages (JAX `causal_dit.py:647-707`): the batch
    rows are the microbatches, each with its rows of the modulation, rope
    angles, start and mask; the stage's layers of the tree, the text /
    image K/V and the cache (written in place, row by row). The flow, or
    None without need_output (no broadcast of the last stage's tokens)."""
    cfg, spec = statics.cfg, statics.spec
    stacked = {"block": params["blocks"], "xk": xattn.k, "xv": xattn.v}
    if xattn.k_img is not None:
        stacked.update(xki=xattn.k_img, xvi=xattn.v_img)
    per_row = isinstance(current_start, torch.Tensor)

    def layer_fn(stk, state, h, i):
        row = slice(i, i + 1)
        img = (stk["xki"][row], stk["xvi"][row]) if "xki" in stk else None

        def rows_of(t):  # per-stream [B, S, D/2] rope tensors: the microbatch's row
            return t[row] if t.dim() == 3 else t

        h, _ = block_forward(
            stk["block"], cfg, spec, h, e0[row], rows_of(angles),
            tuple(f[row] for f in state), stk["xk"][row], stk["xv"][row],
            current_start[row] if per_row else current_start,
            kv_mask[row] if kv_mask.dim() == 2 else kv_mask, xattn_img=img, tp=statics.tp,
            rope=None if rope is None else tuple(rows_of(t) for t in rope))
        return h, state

    outs, _ = pp_pipeline(statics.pp, layer_fn, stacked, tokens[:, None], layer_state=fields,
                          pass_mb_index=True, collect=need_output)
    if not need_output:
        return None
    return unpatchify(head_forward(params, cfg, outs[:, 0], e), cfg, statics.geo)


def _clip_statics(cfg: ModelConfig, x: torch.Tensor, frames: int,
                  dtype: torch.dtype) -> DiTStatics:
    """Statics for a forward of `frames`-frame blocks over a cache sized to
    the whole clip x [B, F, H, W, C] (a global window of exactly F frames)."""
    b, f, hh, ww = x.shape[:4]
    geo = DiTGeometry(frames, hh, ww, cfg.patch_size)
    spec = KVCacheSpec(num_layers=cfg.num_layers, batch=b, max_tokens=f * geo.frame_seq,
                       num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim, dtype=dtype)
    return DiTStatics(cfg=cfg, spec=spec, geo=geo)


@torch.inference_mode()
def dit_forward_bidirectional(
    params: Params, cfg: ModelConfig, rope_tables: RopeTables,
    x: torch.Tensor,              # [B, F, H, W, C] the whole clip
    t: torch.Tensor,              # [B, F]
    xattn: CrossAttnCache,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The non-causal Wan forward (the reference's `WanBaseModel` path for
    bidirectional diffusion): every token attends to the whole clip. One
    inference call whose cache is exactly the clip, from position 0, so the
    prefix mask covers every token. dtype: the cache's; nothing survives
    the call."""
    statics = _clip_statics(cfg, x, x.shape[1], dtype)
    cache = init_kv_cache(statics.spec, device=x.device)
    flow, _ = dit_forward_inference(params, statics, rope_tables, x, t, xattn, cache, 0)
    return flow


@torch.inference_mode()
def dit_forward_block_causal(
    params: Params, cfg: ModelConfig, rope_tables: RopeTables,
    x: torch.Tensor,              # [B, F, H, W, C] the whole clip
    t: torch.Tensor,              # [B, F]
    xattn: CrossAttnCache,
    frames_per_block: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The whole-sequence block-causal forward (the reference's
    teacher-forcing training path with flex-attention block masks): every
    block attends to itself and every earlier block. The blocks go through
    `dit_forward_inference` in order into a clip-sized cache, so the mask
    is the cache's prefix mask."""
    f = x.shape[1]
    if f % frames_per_block:
        raise ValueError(f"{f} frames are not a whole number of "
                         f"{frames_per_block}-frame blocks")
    statics = _clip_statics(cfg, x, frames_per_block, dtype)
    cache = init_kv_cache(statics.spec, device=x.device)
    flows = []
    for bi in range(f // frames_per_block):
        sl = slice(bi * frames_per_block, (bi + 1) * frames_per_block)
        flow, cache = dit_forward_inference(
            params, statics, rope_tables, x[:, sl], t[:, sl], xattn, cache,
            bi * statics.geo.tokens)
        flows.append(flow)
    return torch.cat(flows, dim=1)


@torch.inference_mode()
def dit_forward_teacher_forcing(
    params: Params, cfg: ModelConfig, rope_tables: RopeTables,
    noisy: torch.Tensor,          # [B, F, H, W, C]
    clean: torch.Tensor,          # [B, F, H, W, C] the ground-truth context
    t: torch.Tensor,              # [B, F] timesteps of the noisy blocks
    xattn: CrossAttnCache,
    frames_per_block: int,
    context_noise: float = 0.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Teacher forcing (the reference's `_forward_train` with clean_x):
    noisy block i attends to the CLEAN blocks < i and to itself. Each noisy
    block's forward writes its own K/V into its slots; the clean block's
    forward at `context_noise` then overwrites the same slots in every layer
    before a later block reads them, as the JAX package's discarded write
    and persisted clean write leave them."""
    b, f = noisy.shape[:2]
    if f % frames_per_block:
        raise ValueError(f"{f} frames are not a whole number of "
                         f"{frames_per_block}-frame blocks")
    statics = _clip_statics(cfg, noisy, frames_per_block, dtype)
    cache = init_kv_cache(statics.spec, device=noisy.device)
    t_ctx = torch.full((b, frames_per_block), context_noise, dtype=torch.float32,
                       device=noisy.device)
    flows = []
    for bi in range(f // frames_per_block):
        sl = slice(bi * frames_per_block, (bi + 1) * frames_per_block)
        start = bi * statics.geo.tokens
        flow, cache = dit_forward_inference(params, statics, rope_tables, noisy[:, sl],
                                            t[:, sl], xattn, cache, start)
        flows.append(flow)
        dit_forward_inference(params, statics, rope_tables, clean[:, sl], t_ctx, xattn,
                              cache, start, need_output=False)
    return torch.cat(flows, dim=1)
