"""Quantization API: quantize the parameter tree, and the quantized linears
that read it (port of `inferix_tpu/quant/api.py`).

`quantize_params` replaces each eligible linear's {"w", "b"} with
{"w_q", "scale", "b"}: int8 or e4m3 weights [.., K, N] and f32 scales, one
per output channel (or one per layer). The model's `linear` dispatches on
"w_q", and `quantized_linear` on its dtype.

fp8 (e4m3) weights are weight-only: the bf16 activation goes unquantized
into the fp8-dequant GEMM (`quant.kernels.fp8_matmul`, TPU kernel 9), which
widens the codes to bf16 in the kernel and applies the scale in its
epilogue; the FFN's gelu is a plain pass between fc1 and fc2, and the norm
prologues are the plain chain (the fused prologues quantize to int8).

Every int8 product goes through the hand-written int8 GEMM
(`quant.kernels.int8_matmul`, TPU kernel 8). The JAX package hands the same
product to XLA's int8 dot; PyTorch has no int8 product of its own on the card
that is not a library call, so the port keeps one path for both modes.

Each int8 linear's input is quantized in one pass (`ops.act_quant`, TPU
kernels 5-7), and the FFN gelu runs inside fc2's quantization: the chain the
JAX package takes with `set_fused_act_quant(True)`. The port has no switch
for it and no width gate: on the card these are the only paths, and each
wrapper refuses an operand its kernel cannot take (the TPU's multiple-of-128
width gate does not apply to the CUDA kernels). On CPU tensors the same
wrappers run their plain versions.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.config import QuantConfig
from ..ops.act_quant import (adaln_quantize_rows_int8, ln_quantize_rows_int8,
                             quantize_rows_int8)
from .kernels import (FP8, fp8_matmul, int8_matmul, quantize_weight_fp8,
                      quantize_weight_int8)

Params = Dict[str, Any]

# parameter paths (substring match) that hold quantizable linears inside the
# stacked transformer blocks
_BLOCK_LINEARS = (
    "self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
    "cross_attn/q", "cross_attn/k", "cross_attn/v", "cross_attn/o",
    "ffn/fc1", "ffn/fc2",
)


def _require_int8(p: Params) -> None:
    if p["w_q"].dtype != torch.int8:
        raise TypeError(f"this path takes int8 weights, got {p['w_q'].dtype}")


def _int8_linear(p: Params, x_q: torch.Tensor, x_scale: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """[..., K] int8 codes with their [..., 1] scales through the int8 GEMM
    and its epilogue (the bias added after the cast to out_dtype)."""
    _require_int8(p)
    *lead, k = x_q.shape
    out = int8_matmul(x_q.reshape(-1, k), p["w_q"], x_scale.reshape(-1, 1),
                      p["scale"], out_dtype=out_dtype, bias=p["b"])
    return out.reshape(*lead, out.shape[-1])


def _quantized_rows_linear(p: Params, x: torch.Tensor,
                           act: Optional[str] = None) -> torch.Tensor:
    """x [..., K]: the one-pass act-quant (optional activation first), then
    the int8 GEMM. Returns [..., N] in x's dtype."""
    _require_int8(p)
    *lead, k = x.shape
    x_q, x_scale = quantize_rows_int8(x.reshape(-1, k), act=act)
    return _int8_linear(p, x_q, x_scale, x.dtype).reshape(*lead, -1)


def _fp8_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., K] through the fp8-dequant GEMM, unquantized; the bias added
    after the cast to x's dtype."""
    *lead, k = x.shape
    out = fp8_matmul(x.reshape(-1, k), p["w_q"], p["scale"], out_dtype=x.dtype,
                     bias=p["b"])
    return out.reshape(*lead, out.shape[-1])


def quantized_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., K] through p = {"w_q", "scale", "b"}: int8 weights take a
    per-token int8 quant of x, then the int8 GEMM; e4m3 weights the
    fp8-dequant GEMM on x as it is. Returns [..., N] in x's dtype."""
    if p["w_q"].dtype == FP8:
        return _fp8_linear(p, x)
    return _quantized_rows_linear(p, x)


def use_fused_prologue(p: Params) -> bool:
    """True when linear p holds int8 weights, so the fused LN[/modulate] +
    int8 quant prologue feeds it (float and e4m3 linears take the plain
    norm chain)."""
    return isinstance(p, dict) and "w_q" in p and p["w_q"].dtype == torch.int8


def adaln_quant(x: torch.Tensor, shift: torch.Tensor, scale_mod: torch.Tensor,
                eps: float):
    """Fused LN + AdaLN modulate + quant prologue: (s8 [B, S, C], f32
    [B, S, 1])."""
    return adaln_quantize_rows_int8(x, shift, scale_mod, eps=eps)


def ln_quant(x2: torch.Tensor, weight: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], eps: float):
    """Fused LN (+affine) + quant prologue on [M, C]."""
    return ln_quantize_rows_int8(x2, weight, bias, eps=eps)


def quantized_linear_prequant(p: Params, x_q: torch.Tensor,
                              x_scale: torch.Tensor,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """int8 linear on an input quantized by a fused prologue: x_q [..., K]
    int8, x_scale [..., 1] f32 per token."""
    return _int8_linear(p, x_q, x_scale, out_dtype)


def quantized_ffn(fc1: Params, fc2: Params, x: Optional[torch.Tensor] = None,
                  x_q: Optional[torch.Tensor] = None,
                  x_scale: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fc2(gelu_tanh(fc1(x))). With int8 fc2 weights the gelu runs inside
    fc2's one-pass quantization, so the [M, ffn_dim] gelu tensor is never
    written; e4m3 and float fc2 weights take a plain gelu, then fc2.
    x_q/x_scale: fc1's input, already quantized by the fused AdaLN
    prologue."""
    if x_q is not None:
        h = quantized_linear_prequant(fc1, x_q, x_scale, out_dtype)
    elif "w_q" in fc1:
        h = quantized_linear(fc1, x)
    else:
        h = F.linear(x, fc1["w"].to(x.dtype).t(), fc1["b"].to(x.dtype))
    if "w_q" in fc2 and fc2["w_q"].dtype == torch.int8:
        return _quantized_rows_linear(fc2, h, act="gelu")
    h = F.gelu(h, approximate="tanh")
    if "w_q" in fc2:
        return _fp8_linear(fc2, h)
    return F.linear(h, fc2["w"].to(h.dtype).t(), fc2["b"].to(h.dtype))


def _quantize_leaf_linear(p: Params, qcfg: QuantConfig) -> Params:
    """{"w": [.., K, N], "b"} -> {"w_q", "scale", "b"}; a leading stacked
    layer axis is quantized layer by layer."""
    per_channel = qcfg.granularity == "per_channel"
    if qcfg.dtype == "int8":
        w_q, scale = quantize_weight_int8(p["w"], per_channel)
    elif qcfg.dtype == "fp8":
        w_q, scale = quantize_weight_fp8(p["w"], per_channel)
    else:
        raise ValueError(f"unknown quant dtype {qcfg.dtype!r}")
    return {"w_q": w_q, "scale": scale, "b": p["b"]}


def quantize_params(params: Params, qcfg: QuantConfig) -> Params:
    """Quantize the causal-DiT parameter tree per the qconfig: the linears
    of the transformer blocks, except module paths holding a substring of
    qcfg.exclude, which keep their float weights (as does every linear
    outside the blocks). Every layer is quantized, as in the JAX package."""
    if not qcfg.enabled:
        return params

    def walk(tree, path=""):
        if isinstance(tree, dict):
            if "w" in tree and "b" in tree and getattr(tree["w"], "ndim", 0) >= 2:
                inside_block = any(s in path for s in _BLOCK_LINEARS)
                excluded = any(s in path for s in qcfg.exclude)
                if inside_block and not excluded:
                    return _quantize_leaf_linear(tree, qcfg)
                return tree
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return tree

    return walk(params)


def to_kernel_layout(params: Params) -> Params:
    """The tree with every int8 and e4m3 weight held K-contiguous: `w_q`
    keeps its [.., K, N] shape but lies in memory as [.., N, K] (strides
    (.., 1, K)), the layout the int8 and fp8 GEMM kernels read. One copy is
    made per weight that is not in that layout already, and the tree holds
    only that copy. Float leaves pass through."""
    if isinstance(params, dict):
        if "w_q" in params and params["w_q"].dtype in (torch.int8, FP8):
            w = params["w_q"]
            return {**params, "w_q": w.transpose(-1, -2).contiguous().transpose(-1, -2)}
        return {k: to_kernel_layout(v) for k, v in params.items()}
    return params


# the MAGI trees' transformer-block subtrees: stacked `blocks`, or the fp8
# distill layout's stacked `blocks_mid` between unstacked first / last
MAGI_BLOCK_KEYS = ("blocks", "blocks_mid", "blocks_first", "blocks_last")
_MAGI_BLOCK_LINEARS = ("q", "qx", "k", "v", "kv_xattn", "proj",
                       "fc1", "fc1_up", "fc2")


def _int8_per_layer(w: torch.Tensor, weight_of) -> Params:
    """{"w_q", "scale"}: per-channel int8 of weight_of(sel) for each layer of
    a stacked leaf w [L, K, N] (sel picks that layer's slice of any leaf of
    the linear; one layer, sel the identity, for [K, N]), so the float32
    temporary is one layer's. w_q comes K-contiguous (strides (.., 1, K)),
    the int8 GEMM's layout (`to_kernel_layout`), on w's device."""
    stacked = w.dim() == 3
    layers = w.shape[0] if stacked else 1
    k, n = w.shape[-2:]
    w_q = torch.empty(layers, n, k, dtype=torch.int8, device=w.device).transpose(-1, -2)
    scale = torch.empty(layers, n, dtype=torch.float32, device=w.device)
    for i in range(layers):
        sel = (lambda x, i=i: x[i]) if stacked else (lambda x: x)
        w_q[i], scale[i] = quantize_weight_int8(weight_of(sel), per_channel=True)
    return {"w_q": w_q if stacked else w_q[0], "scale": scale if stacked else scale[0]}


def magi_distill_quant_to_int8(params: Params) -> Params:
    """Requantize a MAGI fp8 distill-quant tree (e4m3 w_q + weight_scale,
    with act_scale, or smooth_scale + input_scale) into W8A8 int8 serving
    weights {w_q int8, scale [out]}, per output channel, the reference's
    activation scaling folded into the weights:

      per-tensor  (act_scale):  W = w_q * weight_scale
      per-channel (smooth_scale, input_scale):
                  W = (input_scale / smooth_scale)[:, None] * w_q * weight_scale

    The dynamic per-token int8 activation quantization of `magi_linear`
    replaces div_clamp_to at run time. Other leaves pass through. Works
    layer by layer on the tree's device (the JAX package asks for the
    host: 4.5B in float32 is ~18 GB); a stacked leaf's row scale is taken
    per layer (input_scale[i] / smooth_scale[i])."""
    def weight(d, sel):
        w = sel(d["w_q"]).float() * sel(d["weight_scale"].float())
        if "smooth_scale" in d:
            w = w * (sel(d["input_scale"].float()) / sel(d["smooth_scale"].float()))[:, None]
        return w

    def walk(tree):
        if isinstance(tree, dict):
            if "w_q" in tree and tree["w_q"].dtype == FP8 and "weight_scale" in tree:
                return _int8_per_layer(tree["w_q"], lambda sel: weight(tree, sel))
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(params)


def magi_quantize_params_int8(params: Params) -> Params:
    """W8A8 int8 serving weights from a plain (bf16 / float32) MAGI tree:
    each transformer-block linear ({"w"} in `_MAGI_BLOCK_LINEARS`) becomes
    {w_q int8, scale [out]} per output channel (its "b", if any, kept; the
    int8 linear does not add it). Embedders, adaLN, norms and the final
    head keep their float weights. Layer by layer on the tree's device;
    w_q in the int8 GEMM's layout."""
    def quant_lin(d):
        out = _int8_per_layer(d["w"], lambda sel: sel(d["w"]).float())
        if "b" in d:
            out["b"] = d["b"]
        return out

    def walk_block(blk):
        return {k: (quant_lin(v) if k in _MAGI_BLOCK_LINEARS and isinstance(v, dict)
                    and "w" in v else v)
                for k, v in blk.items()}

    out = dict(params)
    for key in MAGI_BLOCK_KEYS:
        if key in out:
            out[key] = walk_block(out[key])
    return out


def memory_bytes(params: Params) -> int:
    """Bytes held by the tree's tensors."""
    if isinstance(params, dict):
        return sum(memory_bytes(v) for v in params.values())
    return params.numel() * params.element_size() if isinstance(params, torch.Tensor) else 0
