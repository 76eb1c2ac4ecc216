"""Tensor parallelism's hand-placed collectives. The JAX package has no such
file: it shards the linears' weights (`param_pspecs`, `magi_param_pspecs`)
and GSPMD inserts the collectives. The port runs one process a rank, so
the collectives are placed here, around the linears of a rank's tp shard
(`parallel.mesh.wan_param_shards` / `magi_param_shards`):

- **column linear**: the local matmul on the rank's output columns, no
  collective; its input must be replicated over tp (the models' norms,
  modulation and FFN inputs are). The callers use their own linears;
- **row linear** (`row_linear`, `row_reduce`): the local partial product
  over the rank's input rows, an all-reduce SUM over tp, then the bias
  once. The reduction's dtype: float32 for a quantized GEMM's partials
  (int8, e4m3: their epilogue is float32) and for MAGI's joint projection
  (`_linear_f32_out`, a float32 product); the output dtype for a float
  linear. A rank's sums then differ from one device's only in the order of
  the float32 (or output dtype) additions;
- **full-width RMS norm over head-sharded columns** (`rms_norm_tp`): Wan's
  qk-norm (self-attention q / k, the cross-attention q and text K) is an
  RMS over the whole width, not a head. Each rank holds 1/tp of the
  columns, so its float32 sum of squares is all-reduced before the rsqrt;
  a rank-local norm would give a plausible, wrong result. MAGI's q_ln /
  k_ln / qx_ln / kx_ln are per head, so they stay local (`models/magi/dit.py`);
- **W8A8 under tp** (`quantize_rows_tp`): a column linear's input is
  replicated, so its fused prologue (LN + modulate + quant) is unchanged. A
  row linear's input row is split over the ranks, and its per-token scale
  is the absmax of the whole row: the act-quant kernel's stage 1 gives
  the rank's row absmax (of gelu(x) / silu_mul(x) where the activation is
  folded), an all-reduce MAX makes it the whole row's (exact), and stage
  2 writes the codes from it, so the codes are the slice of the codes one
  device writes, bit for bit.

A group of one (tp 1) makes no exchange: every function here is then the
single-device path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.act_quant import quantize_rows_int8, quantize_rows_int8_given, row_absmax
from ..quant.kernels import FP8, fp8_matmul, int8_matmul
from .mesh import SPMesh

Params = Dict[str, Any]


def rms_norm_tp(tp: Optional[SPMesh], x: torch.Tensor, weight: torch.Tensor,
                eps: float, width: int) -> torch.Tensor:
    """`ops.norms.rms_norm` over rows that each rank of `tp` holds 1/tp of:
    x [..., width / tp] and weight the rank's columns of the norm's weight;
    the mean square of the whole row (`width` values), from the ranks'
    float32 sums of squares (all-reduce SUM over tp)."""
    return rms_norms_tp(tp, (x,), (weight,), eps, width)[0]


def rms_norms_tp(tp: Optional[SPMesh], xs: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor], eps: float,
                 width: int) -> Tuple[torch.Tensor, ...]:
    """`rms_norm_tp` of several tensors of one row count at once (Wan's q
    and k), their sums of squares in one all-reduce."""
    xf = [x.float() for x in xs]
    if tp is None or tp.size == 1:
        ms = [f.square().mean(-1, keepdim=True) for f in xf]
    else:
        sums = tp.all_reduce(torch.cat([f.square().sum(-1, keepdim=True) for f in xf], -1),
                             "sum")
        ms = [m / width for m in sums.split(1, dim=-1)]
    return tuple((f * torch.rsqrt(m + eps)).to(x.dtype) * w.to(x.dtype)
                 for f, m, x, w in zip(xf, ms, xs, weights))


def quantize_rows_tp(tp: Optional[SPMesh], x: torch.Tensor, act: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 codes and f32 scales of x [M, K / tp], the rank's
    slice of rows of width K, with the scale of the whole row (after the
    optional activation, folded as `quantize_rows_int8` folds it; silu_mul
    reads the rank's [gate_t | up_t]). tp 1: `quantize_rows_int8`."""
    if tp is None or tp.size == 1:
        return quantize_rows_int8(x, act=act)
    amax = tp.all_reduce(row_absmax(x, act), "max")
    return quantize_rows_int8_given(x, amax, act)


def row_reduce(tp: Optional[SPMesh], partial: torch.Tensor, out_dtype: torch.dtype,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ranks' partial products summed (all-reduce SUM over tp, in
    partial's dtype), cast to out_dtype, then the bias added once."""
    if tp is not None:
        partial = tp.all_reduce(partial, "sum")
    out = partial.to(out_dtype)
    return out if bias is None else out + bias.to(out_dtype)


def row_linear(tp: Optional[SPMesh], p: Params, x: torch.Tensor,
               act: Optional[str] = None) -> torch.Tensor:
    """A row-parallel Wan linear ({"w", "b"}, int8 or e4m3 {"w_q", "scale",
    "b"}, w [.., K / tp, N]) on the rank's input columns x [..., K / tp],
    with the optional activation of its input first ("gelu": the FFN's
    tanh GELU, which the int8 path folds into the quantization). Returns
    [..., N] in x's dtype, equal on every rank. tp 1: the single-device
    linear."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if "w_q" in p and p["w_q"].dtype == torch.int8:
        x_q, x_s = quantize_rows_tp(tp, x2, act)
        if tp is None or tp.size == 1:
            out = int8_matmul(x_q, p["w_q"], x_s, p["scale"], out_dtype=x.dtype, bias=p["b"])
        else:
            partial = int8_matmul(x_q, p["w_q"], x_s, p["scale"], out_dtype=torch.float32)
            out = row_reduce(tp, partial, x.dtype, p["b"])
        return out.reshape(*lead, -1)
    if act == "gelu":
        x2 = F.gelu(x2, approximate="tanh")
    elif act is not None:
        raise ValueError(f"row_linear folds 'gelu' only, got {act!r}")
    if "w_q" in p:
        if p["w_q"].dtype != FP8:
            raise TypeError(f"unknown weight dtype {p['w_q'].dtype}")
        if tp is None or tp.size == 1:
            out = fp8_matmul(x2, p["w_q"], p["scale"], out_dtype=x.dtype, bias=p["b"])
        else:
            partial = fp8_matmul(x2, p["w_q"], p["scale"], out_dtype=torch.float32)
            out = row_reduce(tp, partial, x.dtype, p["b"])
        return out.reshape(*lead, -1)
    if tp is None or tp.size == 1:
        out = F.linear(x2, p["w"].to(x.dtype).t(), p["b"].to(x.dtype))
    else:
        out = row_reduce(tp, F.linear(x2, p["w"].to(x.dtype).t()), x.dtype, p["b"])
    return out.reshape(*lead, -1)
