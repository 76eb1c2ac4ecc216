"""W8A8 int8 quantization helpers and the int8 GEMM: the wrapper of the
hand-written CUDA kernel (`csrc/int8_matmul.cu`) and its plain PyTorch
version.

Port of `inferix_tpu/quant/kernels.py`: `quantize_weight_int8` (`:40`),
`quantize_act_int8_per_token` (`:68`), `int8_matmul` (`:107`, TPU kernel
`_int8_matmul_kernel` `:81`) and `int8_matmul_xla` (`:254`, here
`int8_matmul_reference`). The quantizers are plain tensor ops with the JAX
package's arithmetic: f32 absmax, scale = max(absmax / 127, 1e-8), a true
division, round half to even, clip to +-127.

Weight layout. `w_q` is the JAX package's [K, N] (in, out) weight. The
kernel's tensor-core operand wants each output channel's K bytes contiguous,
and ldmatrix can transpose 16-bit elements only, so the kernel takes `w_q` as
a K-contiguous [K, N] view: an [N, K] tensor in memory, seen through
`.t()` (strides (1, K)). `quant.api.to_kernel_layout` makes that layout once,
when the generator is built; the weight is then held in that one copy only.
The plain version takes either layout.

On CUDA tensors `int8_matmul` launches the kernel or raises; it never falls
back. On CPU tensors it takes `int8_matmul_reference`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

INT8_MAX = 127.0
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def scale_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax / 127, 1e-8), the division a true one on every device:
    PyTorch's CUDA division by a Python number multiplies by its reciprocal
    instead, which moves some scales by an ulp."""
    return torch.clamp_min(absmax / absmax.new_full((), INT8_MAX), 1e-8)


def quantize_weight_int8(w: torch.Tensor, per_channel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., K, N] -> (w_q int8 [..., K, N], scale f32 [..., N] or
    [..., 1]); leading axes (stacked layers) are quantized one by one."""
    wf = w.float()
    if per_channel:
        absmax = wf.abs().amax(dim=-2)
    else:
        absmax = wf.abs().amax(dim=(-2, -1)).unsqueeze(-1)
    scale = scale_from_absmax(absmax)
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_act_int8_per_token(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (x_q int8 [..., K], scale f32 [..., 1]): dynamic
    per-token quantization."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = scale_from_absmax(absmax)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def fp8_not_ported(*_args, **_kwargs):
    """Stands in for the fp8 entry points; always raises."""
    raise NotImplementedError(
        "fp8 (e4m3) weights are not ported yet: TPU kernel 9, "
        "`inferix_tpu/quant/kernels.py:_fp8_matmul_kernel`, ROADMAP.md B8")


quantize_weight_fp8 = fp8_matmul = fp8_matmul_reference = fp8_not_ported


def _check_scales(x_scale: torch.Tensor, w_scale: torch.Tensor, m: int, n: int):
    if x_scale.numel() not in (1, m):
        raise ValueError(f"x_scale must hold 1 or M={m} values, got {tuple(x_scale.shape)}")
    if w_scale.numel() not in (1, n):
        raise ValueError(f"w_scale must hold 1 or N={n} values, got {tuple(w_scale.shape)}")


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


def _kernel():
    lib = _build.load_library("int8_matmul")
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
        raise ValueError(f"the kernel needs K % 16 == 0 (16-byte cp.async) and "
                         f"N % 8 == 0, got K={k}, N={n}")
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
    if (m + 127) // 128 > 65535:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")


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
