"""Fused per-token int8 activation quantization: the wrappers of the
hand-written CUDA kernels (`csrc/act_quant.cu`) and their plain PyTorch
versions.

Port of `inferix_tpu/ops/act_quant.py`:
- `quantize_rows_int8` (`:94`, TPU kernel `_quant_kernel` `:66`): one row a
  token, an optional activation (`gelu`, `gelu_exact`, `silu_mul`) first,
  then the row's absmax -> int8 codes + an f32 scale;
  `row_absmax` and `quantize_rows_int8_given` are the same kernel's two
  stages for a tensor-parallel row (no JAX counterpart: the JAX package
  leaves the global absmax to GSPMD): each rank's row absmax, then, after
  the caller's MAX over the ranks, the codes from the whole row's scale;
- `adaln_quantize_rows_int8` (`:199`) and `ln_quantize_rows_int8` (`:256`),
  TPU kernel `_ln_mod_quant_kernel` (`:154`): LayerNorm, then the per-frame
  AdaLN modulate or the affine weight/bias, then the same quantization.

The arithmetic is the JAX kernels', rounding point for rounding point: f32
statistics, the result rounded to the activation dtype where the JAX chain
rounds it, scale = max(absmax / 127, 1e-8), codes round(x / scale) half to
even, clipped to +-127. The LayerNorm takes 1 / sqrt(var + eps) (both here
and in the kernel), where the TPU kernel takes rsqrt: the two differ by at
most an ulp of f32.

On CUDA tensors each wrapper launches its kernel (bfloat16 input) or raises;
it never falls back. On CPU tensors it takes the plain version. The kernels
hold a row in registers, G threads a row; `row_plan` picks G and the chunks
a thread from the row's width, and the launcher takes no other class.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..quant.kernels import quantize_act_int8_per_token, scale_from_absmax

ACTS = (None, "gelu", "gelu_exact", "silu_mul")
_ACT_CODE = {a: i for i, a in enumerate(ACTS)}
# The kernels' row classes (csrc/act_quant.cu `quant_class`): G threads own
# a row and each holds at most this many 16-byte chunks (8 values) of it in
# registers. A wider act-quant row takes the widest G reading the row twice;
# the LayerNorm kernel holds its row or refuses it.
ROW_CLASSES = ((16, 1), (32, 6), (128, 9), (128, 12))
MAX_LN_WIDTH = 8 * ROW_CLASSES[-1][0] * ROW_CLASSES[-1][1]  # 12288

_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT2 = 0.7071067811865476
# Abramowitz-Stegun 7.1.26, the TPU kernel's erf (`act_quant.py:48`)
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    a1, a2, a3, a4, a5 = _AS_A
    ax = x.abs()
    t = 1.0 / (1.0 + _AS_P * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * torch.exp(-ax * ax)
    return torch.where(x < 0, -y, y)


def apply_act_fused(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The kernel's activation in f32, rounded to x's dtype where the JAX
    kernel rounds it; returns f32."""
    xf = x.float()
    if act is None:
        return xf
    if act == "gelu":
        return _gelu_tanh_f32(xf).to(x.dtype).float()
    if act == "gelu_exact":
        return (0.5 * xf * (1.0 + _erf_f32(xf * _INV_SQRT2))).to(x.dtype).float()
    if act == "silu_mul":
        d = xf.shape[-1] // 2
        gate = xf[..., :d]
        gate = (gate * torch.sigmoid(gate)).to(x.dtype)
        return (gate * x[..., d:]).float()
    raise ValueError(f"unknown act {act!r}")


def _out_width(k: int, act: Optional[str]) -> int:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if act == "silu_mul" and k % 2:
        raise ValueError(f"silu_mul needs an even width, got {k}")
    return k // 2 if act == "silu_mul" else k


def row_plan(width: int) -> Tuple[int, int]:
    """(G, chunks a thread) of the kernels for rows of `width` quantized
    values: the first class whose G threads cover the row's width / 8
    chunks with at most its chunks a thread, else the widest G (the
    act-quant kernel then reads the row twice). Refuses a width that is not
    a positive multiple of 8 (the kernels' 16-byte loads)."""
    if width <= 0 or width % 8:
        raise ValueError(f"the act-quant kernels need a width that is a positive "
                         f"multiple of 8 (16-byte loads), got {width}")
    chunks = width // 8
    for g, most in ROW_CLASSES:
        if -(-chunks // g) <= most:
            return g, -(-chunks // g)
    g = ROW_CLASSES[-1][0]
    return g, -(-chunks // g)


def quantize_rows_int8_reference(x: torch.Tensor, act: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the act-quant kernel: (x_q s8 [M, K'], scale f32
    [M, 1]), K' = K // 2 for silu_mul ([gate | up] in), else K."""
    _out_width(x.shape[-1], act)
    return quantize_act_int8_per_token(apply_act_fused(x, act))


def row_absmax_reference(x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """Plain version of the act-quant kernel's stage 1: each row's absmax
    after the activation, f32 [M, 1]."""
    _out_width(x.shape[-1], act)
    return apply_act_fused(x, act).abs().amax(dim=-1, keepdim=True)


def quantize_rows_int8_given_reference(x: torch.Tensor, absmax: torch.Tensor,
                                       act: Optional[str] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the act-quant kernel's stage 2: the codes and scales
    of x's rows (after the activation) from the given row absmax [M, 1]
    (scale = max(absmax / 127, 1e-8)), as `quantize_rows_int8_reference`
    takes them from the row's own."""
    _out_width(x.shape[-1], act)
    scale = scale_from_absmax(absmax.float().reshape(-1, 1))
    q = torch.clamp(torch.round(apply_act_fused(x, act) / scale), -127, 127)
    return q.to(torch.int8), scale


def _layer_norm_f32(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * (1.0 / torch.sqrt(var + eps))


def adaln_quantize_rows_int8_reference(
    x: torch.Tensor, shift: torch.Tensor, scale_mod: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the LN + modulate + quant kernel. x [B, S, C] with S
    = F * frame_seq, shift/scale_mod [B, F, C] f32. LN in f32, rounded to
    x's dtype; then h * dtype(1 + scale) + dtype(shift) with each op rounded
    to x's dtype; then per-token quant. Returns (s8 [B, S, C], f32 [B, S, 1])."""
    b, s, c = x.shape
    f = shift.shape[1]
    if s % f:
        raise ValueError(f"S = {s} is not a multiple of the {f} frames")
    dt = x.dtype
    h = _layer_norm_f32(x, eps).to(dt).reshape(b, f, s // f, c)
    sc = (1.0 + scale_mod.float()).to(dt)[:, :, None, :]
    sh = shift.to(dt)[:, :, None, :]
    h = (h * sc + sh).reshape(b, s, c)
    return quantize_act_int8_per_token(h)


def ln_quantize_rows_int8_reference(
    x: torch.Tensor, weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the LN (+ affine) + quant kernel on x [M, C]: the
    affine weight and bias applied in f32, the result cast once."""
    ln = _layer_norm_f32(x, eps)
    if weight is not None:
        ln = ln * weight.float() + bias.float()
    return quantize_act_int8_per_token(ln.to(x.dtype))


_ARGTYPES_QUANT = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])        # x, q, s, M, K, act, G, chunks, stream
_ARGTYPES_LN = (
    [ctypes.c_void_p] * 4                      # x, q, s, p0 (shift or weight)
    + [ctypes.c_void_p]                        # p1 (scale or bias)
    + [ctypes.c_longlong] * 2                  # modulation batch, frame strides
    + [ctypes.c_int] * 4                       # M, C, rows per batch, frame_seq
    + [ctypes.c_float] + [ctypes.c_int] * 3    # eps, mode, G, chunks
    + [ctypes.c_void_p]                        # stream
)
_ARGTYPES_QUANT_TP = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])   # x, q, s, amax, M, K, act, G, chunks, stage, stream
_MODE = {"plain": 0, "affine": 1, "modulate": 2}
_STAGE_ABSMAX, _STAGE_GIVEN = 1, 2


def _lib():
    lib = _build.load_library("act_quant")
    if lib.inferix_quantize_rows_int8.argtypes is None:
        lib.inferix_quantize_rows_int8.argtypes = _ARGTYPES_QUANT
        lib.inferix_quantize_rows_int8.restype = ctypes.c_int
        lib.inferix_ln_quantize_rows_int8.argtypes = _ARGTYPES_LN
        lib.inferix_ln_quantize_rows_int8.restype = ctypes.c_int
        lib.inferix_quantize_rows_int8_tp.argtypes = _ARGTYPES_QUANT_TP
        lib.inferix_quantize_rows_int8_tp.restype = ctypes.c_int
    return lib


def _check_x(x: torch.Tensor, dims: int, width_mult: int = 8):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the act-quant kernels take bfloat16, got {x.dtype}")
    if x.dim() != dims or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be a contiguous {dims}-d tensor with a 16-byte "
                         f"aligned base, got shape {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    if x.shape[-1] % width_mult:
        raise ValueError(f"the kernel needs a width that is a multiple of "
                         f"{width_mult} (16-byte loads), got {x.shape[-1]}")


def _check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def quantize_rows_int8(x: torch.Tensor, act: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass per-token int8 quant of x [M, K], with the optional
    activation folded in: (x_q s8 [M, K'], scale f32 [M, 1]). On CUDA
    tensors this launches the kernel and counts it in
    `quantize_rows_int8.launches`; on CPU tensors it takes the plain
    version."""
    k_out = _out_width(x.shape[-1], act)
    if not x.is_cuda:
        return quantize_rows_int8_reference(x, act)
    _check_x(x, 2, 16 if act == "silu_mul" else 8)
    g, nc = row_plan(k_out)
    m, k = x.shape
    q = torch.empty(m, k_out, dtype=torch.int8, device=x.device)
    s = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m == 0:
        return q, s
    if m > 2**31 - 1:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")
    with torch.cuda.device(x.device):
        err = _lib().inferix_quantize_rows_int8(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k, _ACT_CODE[act], g, nc,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, "quantize_rows_int8")
    quantize_rows_int8.launches += 1
    return q, s


quantize_rows_int8.launches = 0


def _tp_launch(x: torch.Tensor, act: Optional[str], stage: int,
               absmax: Optional[torch.Tensor]):
    k_out = _out_width(x.shape[-1], act)
    _check_x(x, 2, 16 if act == "silu_mul" else 8)
    g, nc = row_plan(k_out)
    m = x.shape[0]
    q = (torch.empty(m, k_out, dtype=torch.int8, device=x.device) if stage == _STAGE_GIVEN
         else None)
    s = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m == 0:
        return q, s
    if m > 2**31 - 1:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")
    if absmax is not None and (absmax.device != x.device or absmax.dtype != torch.float32
                               or absmax.numel() != m or not absmax.is_contiguous()):
        raise ValueError(f"absmax must be a contiguous float32 [{m}, 1] tensor on {x.device}")
    with torch.cuda.device(x.device):
        err = _lib().inferix_quantize_rows_int8_tp(
            x.data_ptr(), None if q is None else q.data_ptr(), s.data_ptr(),
            None if absmax is None else absmax.data_ptr(), m, x.shape[1], _ACT_CODE[act],
            g, nc, stage, torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, "quantize_rows_int8 (tp stage)")
    return q, s


def row_absmax(x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """Each row's absmax of x [M, K] after the optional activation, f32
    [M, 1]: the act-quant kernel's stage 1, for a row that a tensor-parallel
    rank holds 1/tp of (the caller reduces it over the ranks with MAX). On
    CUDA tensors this launches the kernel and counts it in
    `row_absmax.launches`; on CPU tensors it takes the plain version."""
    if not x.is_cuda:
        return row_absmax_reference(x, act)
    _, s = _tp_launch(x, act, _STAGE_ABSMAX, None)
    if x.shape[0]:
        row_absmax.launches += 1
    return s


row_absmax.launches = 0


def quantize_rows_int8_given(x: torch.Tensor, absmax: torch.Tensor,
                             act: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 codes and scales of x [M, K] (after the optional activation)
    from the given row absmax [M, 1] f32: the act-quant kernel's stage 2.
    With the absmax of the whole row, a rank's codes are the slice of the
    codes `quantize_rows_int8` gives the whole row. On CUDA tensors this
    launches the kernel and counts it in `quantize_rows_int8_given.launches`;
    on CPU tensors it takes the plain version."""
    if not x.is_cuda:
        return quantize_rows_int8_given_reference(x, absmax, act)
    q, s = _tp_launch(x, act, _STAGE_GIVEN, absmax.reshape(-1, 1).contiguous())
    if x.shape[0]:
        quantize_rows_int8_given.launches += 1
    return q, s


quantize_rows_int8_given.launches = 0


def _ln_launch(x2, p0, p1, sb, sf, rows_per_batch, frame_seq, eps, mode):
    m, c = x2.shape
    q = torch.empty(m, c, dtype=torch.int8, device=x2.device)
    s = torch.empty(m, 1, dtype=torch.float32, device=x2.device)
    if m == 0:
        return q, s
    if c > MAX_LN_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths up to {MAX_LN_WIDTH}, got {c}")
    g, nc = row_plan(c)
    if m > 2**31 - 1:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")
    with torch.cuda.device(x2.device):
        err = _lib().inferix_ln_quantize_rows_int8(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(),
            None if p0 is None else p0.data_ptr(),
            None if p1 is None else p1.data_ptr(),
            sb, sf, m, c, rows_per_batch, frame_seq, float(eps), _MODE[mode], g, nc,
            torch.cuda.current_stream(x2.device).cuda_stream)
    _check_launch(err, f"ln_quantize_rows_int8 ({mode})")
    return q, s


def adaln_quantize_rows_int8(
    x: torch.Tensor,          # [B, S, C], S = F * frame_seq
    shift: torch.Tensor,      # [B, F, C] f32
    scale_mod: torch.Tensor,  # [B, F, C] f32
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass LN + per-frame AdaLN modulate + per-token int8 quant:
    (x_q s8 [B, S, C], scale f32 [B, S, 1]). The token s of batch row b
    takes frame s // (S / F)'s shift and scale. On CUDA tensors this launches
    the kernel and counts it in `adaln_quantize_rows_int8.launches`; on CPU
    tensors it takes the plain version. shift and scale_mod may be strided
    views (e.g. slices of the [B, F, 6, C] modulation) with a contiguous C
    axis."""
    if not x.is_cuda:
        return adaln_quantize_rows_int8_reference(x, shift, scale_mod, eps)
    _check_x(x, 3)
    b, s, c = x.shape
    if shift.shape != scale_mod.shape or shift.dim() != 3 \
            or shift.shape[0] != b or shift.shape[2] != c:
        raise ValueError(f"shift/scale_mod must be [B={b}, F, C={c}], got "
                         f"{tuple(shift.shape)} and {tuple(scale_mod.shape)}")
    f = shift.shape[1]
    if f == 0 or s % f:
        raise ValueError(f"S = {s} is not a multiple of the {f} frames")
    for name, t in (("shift", shift), ("scale_mod", scale_mod)):
        if t.device != x.device or t.dtype != torch.float32 or t.stride(2) != 1:
            raise ValueError(f"{name} must be float32 on {x.device} with a "
                             f"contiguous C axis")
    if shift.stride()[:2] != scale_mod.stride()[:2]:
        raise ValueError("shift and scale_mod must share their strides")
    q, sc = _ln_launch(x.reshape(b * s, c), shift, scale_mod, shift.stride(0),
                       shift.stride(1), s, s // f, eps, "modulate")
    if b * s:
        adaln_quantize_rows_int8.launches += 1
    return q.reshape(b, s, c), sc.reshape(b, s, 1)


adaln_quantize_rows_int8.launches = 0


def ln_quantize_rows_int8(
    x: torch.Tensor,                        # [M, C]
    weight: Optional[torch.Tensor] = None,  # [C] affine (norm3) or None
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass LN (optionally affine) + per-token int8 quant of x [M, C]:
    (x_q s8 [M, C], scale f32 [M, 1]). On CUDA tensors this launches the
    kernel and counts it in `ln_quantize_rows_int8.launches`; on CPU tensors
    it takes the plain version."""
    if (weight is None) != (bias is None):
        raise ValueError("the affine LayerNorm needs both weight and bias")
    if not x.is_cuda:
        return ln_quantize_rows_int8_reference(x, weight, bias, eps)
    _check_x(x, 2)
    m, c = x.shape
    if weight is not None:
        for name, t in (("weight", weight), ("bias", bias)):
            if t.device != x.device or t.dtype != x.dtype or t.numel() != c \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous [{c}] {x.dtype} "
                                 f"tensor on {x.device}")
    q, s = _ln_launch(x, weight, bias, 0, 0, max(m, 1), max(m, 1), eps,
                      "plain" if weight is None else "affine")
    if m:
        ln_quantize_rows_int8.launches += 1
    return q, s


ln_quantize_rows_int8.launches = 0

