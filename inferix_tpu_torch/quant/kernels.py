"""Weight quantization helpers and the quantized GEMMs: the W8A8 int8 GEMM
and the fp8 weight-only GEMM, two entry points of one hand-written CUDA
kernel frame (`csrc/gemm_sm90.cu`), each wrapper beside its plain PyTorch
version.

Port of `inferix_tpu/quant/kernels.py`: `quantize_weight_int8` (`:40`),
`quantize_weight_fp8` (`:54`), `quantize_act_int8_per_token` (`:68`),
`int8_matmul` (`:107`, TPU kernel `_int8_matmul_kernel` `:81`),
`fp8_matmul` (`:194`, TPU kernel `_fp8_matmul_kernel` `:171`) and the XLA
versions `int8_matmul_xla` / `fp8_matmul_xla` (`:254`, here the
`*_reference` functions). The quantizers are plain tensor ops with the JAX
package's arithmetic: f32 absmax, scale = max(absmax / 127 (or 448),
1e-8), a true division; int8 codes round half to even and clip to +-127,
e4m3 codes are the f32 quotient rounded to nearest even.

Weight layout. `w_q` is the JAX package's [K, N] (in, out) weight. Both
kernels take it as a K-contiguous [K, N] view: an [N, K] tensor in memory,
seen through `.t()` (strides (1, K)). The int8 kernel needs that layout
because its tensor-core operand wants each output channel's K bytes
contiguous (wgmma takes s8 operands K-major only). The fp8 kernel computes
the transposed product out^T = W . x^T: TMA loads the raw [N, K] e4m3 tiles,
each thread widens its share in registers into wgmma's A operand, and x is
the B operand through a shared-memory descriptor.
`quant.api.to_kernel_layout` makes that layout once, when the generator is
built; the weight is then held in that one copy only. The plain versions
take either layout.

On CUDA tensors `int8_matmul` and `fp8_matmul` launch their kernels or
raise; they never fall back. On CPU tensors they take their plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

INT8_MAX = 127.0
FP8_MAX = 448.0  # the largest finite e4m3fn value
FP8 = torch.float8_e4m3fn
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def scale_from_absmax(absmax: torch.Tensor, qmax: float = INT8_MAX) -> torch.Tensor:
    """max(absmax / qmax, 1e-8), the division a true one on every device:
    PyTorch's CUDA division by a Python number multiplies by its reciprocal
    instead, which moves some scales by an ulp."""
    return torch.clamp_min(absmax / absmax.new_full((), qmax), 1e-8)


def _weight_absmax(wf: torch.Tensor, per_channel: bool) -> torch.Tensor:
    if per_channel:
        return wf.abs().amax(dim=-2)
    return wf.abs().amax(dim=(-2, -1)).unsqueeze(-1)


def quantize_weight_int8(w: torch.Tensor, per_channel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., K, N] -> (w_q int8 [..., K, N], scale f32 [..., N] or
    [..., 1]); leading axes (stacked layers) are quantized one by one."""
    wf = w.float()
    scale = scale_from_absmax(_weight_absmax(wf, per_channel))
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_weight_fp8(w: torch.Tensor, per_channel: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., K, N] -> (w_q float8_e4m3fn [..., K, N], scale f32 [..., N]
    or [..., 1]): scale = max(absmax / 448, 1e-8), codes (w / scale) rounded
    to the nearest e4m3 value, ties to even (|w / scale| <= 448 up to a
    rounding of the quotient, which rounds back to 448). Leading axes
    (stacked layers) are quantized one by one."""
    wf = w.float()
    scale = scale_from_absmax(_weight_absmax(wf, per_channel), FP8_MAX)
    return (wf / scale.unsqueeze(-2)).to(FP8), scale


def quantize_act_int8_per_token(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (x_q int8 [..., K], scale f32 [..., 1]): dynamic
    per-token quantization."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = scale_from_absmax(absmax)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _check_w_scale(w_scale: torch.Tensor, n: int):
    if w_scale.numel() not in (1, n):
        raise ValueError(f"w_scale must hold 1 or N={n} values, got {tuple(w_scale.shape)}")


def _check_scales(x_scale: torch.Tensor, w_scale: torch.Tensor, m: int, n: int):
    if x_scale.numel() not in (1, m):
        raise ValueError(f"x_scale must hold 1 or M={m} values, got {tuple(x_scale.shape)}")
    _check_w_scale(w_scale, n)


def int8_matmul_reference(
    x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
    w_scale: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: x_q [M, K] s8 @ w_q [K, N] s8 summed
    exactly (int32 on the CPU; float64 on the card, exact since |acc| <=
    127^2 * K < 2^53), then the kernel's epilogue: f32(acc) * x_scale *
    w_scale, in that order, cast to out_dtype, then + bias cast to out_dtype
    (the sum rounded to out_dtype), as `quantized_linear` adds it."""
    m, k = x_q.shape
    n = w_q.shape[1]
    _check_scales(x_scale, w_scale, m, n)
    acc_dtype = torch.float64 if x_q.is_cuda else torch.int32
    acc = torch.matmul(x_q.to(acc_dtype), w_q.to(acc_dtype))
    xs = x_scale.float().reshape(-1, 1)
    ws = w_scale.float().reshape(1, -1)
    out = (acc.to(torch.float32) * xs * ws).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p]       # x_q, w_q
    + [ctypes.c_void_p, ctypes.c_int] * 2    # x_scale + stride, w_scale + stride
    + [ctypes.c_void_p, ctypes.c_void_p]     # bias (or null), out
    + [ctypes.c_int] * 4                     # M, N, K, out_f32
    + [ctypes.c_void_p]                      # stream
)


GEMM_LIBRARY = "gemm_sm90"  # csrc/gemm_sm90.cu: both GEMMs


def _kernel():
    lib = _build.load_library(GEMM_LIBRARY)
    fn = lib.inferix_int8_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(x_q, w_q, x_scale, w_scale, bias, out_dtype):
    dev = x_q.device
    for name, t in (("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale),
                    ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, x_q on {dev}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"x_q [M, K] and w_q [K, N] expected, got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 16 or n % 8:
        raise ValueError(f"the kernel needs K % 16 == 0 and N % 8 == 0 (16-byte rows of "
                         f"its tensor maps), got K={k}, N={n}")
    if not x_q.is_contiguous() or x_q.data_ptr() % 16:
        raise ValueError("x_q must be contiguous with a 16-byte aligned base")
    if w_q.stride() != (1, k) or w_q.data_ptr() % 16:
        raise ValueError(
            f"w_q must be a K-contiguous [K, N] view (strides (1, {k}), an "
            f"[N, K] tensor seen through .t(); see quant.api.to_kernel_layout) "
            f"with a 16-byte aligned base, got strides {w_q.stride()}")
    for name, t in (("x_scale", x_scale), ("w_scale", w_scale)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32, got {t.dtype}")
    _check_scales(x_scale, w_scale, m, n)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold N={n} values, got {tuple(bias.shape)}")


def int8_matmul(
    x_q: torch.Tensor,       # [M, K] int8, contiguous
    w_q: torch.Tensor,       # [K, N] int8, K-contiguous on the card
    x_scale: torch.Tensor,   # [M, 1] f32 per token, or one value
    w_scale: torch.Tensor,   # [N] f32 per channel, or one value
    out_dtype: torch.dtype = torch.bfloat16,
    bias: Optional[torch.Tensor] = None,  # [N], added after the cast
) -> torch.Tensor:
    """W8A8 GEMM with the scale epilogue: f32(x_q @ w_q) * x_scale * w_scale
    -> out_dtype (+ bias). On CUDA tensors this launches the hand-written
    kernel and counts the launch in `int8_matmul.launches`; on CPU tensors it
    takes the plain version."""
    if not x_q.is_cuda:
        if any(t is not None and t.is_cuda for t in (w_q, x_scale, w_scale, bias)):
            raise ValueError("int8_matmul operands must lie on one device")
        return int8_matmul_reference(x_q, w_q, x_scale, w_scale, out_dtype, bias)
    _check_cuda_operands(x_q, w_q, x_scale, w_scale, bias, out_dtype)
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x_q.device)
    if m == 0:
        return out
    if bias is not None:
        bias = bias.reshape(-1).to(out_dtype).contiguous()
    fn = _kernel()
    with torch.cuda.device(x_q.device):
        err = fn(x_q.data_ptr(), w_q.data_ptr(),
                 x_scale.data_ptr(), int(x_scale.numel() != 1),
                 w_scale.data_ptr(), int(w_scale.numel() != 1),
                 bias.data_ptr() if bias is not None else None, out.data_ptr(),
                 m, n, k, int(out_dtype == torch.float32),
                 torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def fp8_matmul_reference(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the fp8 kernel: x [M, K] @ w_q [K, N] e4m3 with the
    codes widened exactly, the products summed in float32, times the float32
    scale (one per column, or one for all), rounded once to out_dtype, then
    + bias cast to out_dtype (the sum rounded to out_dtype), as
    `quantized_linear` adds it. The kernel takes bf16 x; x's values are used
    as given, so a float32 x (the CPU tests' dtype) is not rounded to bf16,
    as the JAX package's XLA chain does not round it in float32."""
    if w_q.dtype != FP8:
        raise TypeError(f"w_q must be float8_e4m3fn, got {w_q.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x [M, K] and w_q [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    _check_w_scale(w_scale, w_q.shape[1])
    acc = torch.matmul(x.float(), w_q.float())
    out = (acc * w_scale.float().reshape(1, -1)).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


_FP8_ARGTYPES = (
    [ctypes.c_void_p] * 3                    # x, w_q, w_scale
    + [ctypes.c_int]                         # w_scale stride (0: one for all)
    + [ctypes.c_void_p, ctypes.c_void_p]     # bias (or null), out
    + [ctypes.c_int] * 4                     # M, N, K, out_f32
    + [ctypes.c_void_p]                      # stream
)


def _fp8_kernel():
    lib = _build.load_library(GEMM_LIBRARY)
    fn = lib.inferix_fp8_matmul
    if fn.argtypes is None:
        fn.argtypes = _FP8_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_fp8_cuda_operands(x, w_q, w_scale, bias, out_dtype):
    dev = x.device
    for name, t in (("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, x on {dev}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 for the CUDA kernel, got {x.dtype}")
    if w_q.dtype != FP8:
        raise TypeError(f"w_q must be float8_e4m3fn, got {w_q.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x [M, K] and w_q [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if k % 16 or n % 8:
        raise ValueError(f"the kernel needs K % 16 == 0 (16-byte rows of its "
                         f"tensor maps) and N % 8 == 0, got K={k}, N={n}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous with a 16-byte aligned base")
    if w_q.stride() != (1, k) or w_q.data_ptr() % 16:
        raise ValueError(
            f"w_q must be a K-contiguous [K, N] view (strides (1, {k}), an "
            f"[N, K] tensor seen through .t(); see quant.api.to_kernel_layout) "
            f"with a 16-byte aligned base, got strides {w_q.stride()}")
    if w_scale.dtype != torch.float32 or not w_scale.is_contiguous():
        raise TypeError(f"w_scale must be contiguous float32, got {w_scale.dtype}")
    _check_w_scale(w_scale, n)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold N={n} values, got {tuple(bias.shape)}")


GEMM_TILE_M = 128                # rows of a tile (of the rows operand)
GEMM_TILE_N = (256, 224, 128)    # the tile widths, widest first
GEMM_TILE_COST = 48              # a tile's fixed work, in columns (kTileCost)
H100_SMS = 132


def gemm_plan(m: int, n: int, kernel: str = "int8", sms: int = H100_SMS
              ) -> Tuple[int, int, int]:
    """The tile plan of the int8 or the fp8 GEMM launcher for [m, k] x [k,
    n] (`plan_of` in csrc/gemm_sm90.cu, the same rule): (tile width, tiles,
    CTAs). A tile is 128 rows of the rows operand (tokens, or channels for
    the fp8 kernel's transposed product) by the width; the width is the one
    whose rounds of tiles over the `sms` SMs cost the least, a tile costing
    its width plus GEMM_TILE_COST columns, the wider on a tie; the
    persistent grid is one CTA an SM, or one a tile when there are fewer
    tiles."""
    if kernel not in ("int8", "fp8"):
        raise ValueError(f"kernel must be 'int8' or 'fp8', got {kernel!r}")
    rows, cols = (n, m) if kernel == "fp8" else (m, n)
    best = None
    for bn in GEMM_TILE_N:
        tiles = -(-rows // GEMM_TILE_M) * -(-cols // bn)
        cost = -(-tiles // sms) * (bn + GEMM_TILE_COST)
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    return bn, tiles, min(tiles, sms)


def fp8_matmul(
    x: torch.Tensor,         # [M, K] bf16 activations (never quantized)
    w_q: torch.Tensor,       # [K, N] float8_e4m3fn, K-contiguous on the card
    w_scale: torch.Tensor,   # [N] f32 per channel, or one value
    out_dtype: torch.dtype = torch.bfloat16,
    bias: Optional[torch.Tensor] = None,  # [N], added after the cast
) -> torch.Tensor:
    """fp8 weight-only GEMM: f32(x @ widen(w_q)) * w_scale -> out_dtype
    (+ bias). On CUDA tensors this launches the hand-written kernel and
    counts the launch in `fp8_matmul.launches`; on CPU tensors it takes the
    plain version."""
    if not x.is_cuda:
        if any(t is not None and t.is_cuda for t in (w_q, w_scale, bias)):
            raise ValueError("fp8_matmul operands must lie on one device")
        return fp8_matmul_reference(x, w_q, w_scale, out_dtype, bias)
    _check_fp8_cuda_operands(x, w_q, w_scale, bias, out_dtype)
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    if bias is not None:
        bias = bias.reshape(-1).to(out_dtype).contiguous()
    fn = _fp8_kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                 int(w_scale.numel() != 1),
                 bias.data_ptr() if bias is not None else None, out.data_ptr(),
                 m, n, k, int(out_dtype == torch.float32),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8_matmul kernel launch failed: CUDA error {err}")
    fp8_matmul.launches += 1
    return out


fp8_matmul.launches = 0
