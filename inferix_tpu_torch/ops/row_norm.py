"""The norm chains of the bf16 Wan layer as row kernels: the wrappers of the
hand-written CUDA kernels (`csrc/row_norm.cu`) and their plain PyTorch
versions.

- `ln_rows`: LayerNorm rows cast to bf16, then the per-frame AdaLN modulate
  (`models/wan/causal_dit.py:_modulate`: the qkv, fc1 and head prologues),
  or the affine weight and bias (norm3), or nothing; the chain of
  `ops/norms.py:layer_norm` and `_modulate`;
- `rms_rows`: RMS norm rows cast to bf16, times the weight, then the 3-D
  rope from a cos / sin table (`rope_cos_sin`): the self-attention's q and k
  in one launch, each read through its row stride (the fused qkv output's
  columns, no copy), or one input without rope (the cross-attention's q);
  the chain of `parallel/tensor_parallel.py:rms_norms_tp` at tp 1 and
  `ops/rope.py:apply_rope`.

No TPU kernel stands behind them: the JAX package runs these chains as XLA
ops. The kernels round where the chain rounds, as PyTorch runs it on the
card (`csrc/row_norm.cu`), so they differ from it only where the row's sums,
added in another order, round to another f32 statistic.

On CUDA tensors each wrapper launches its kernel or raises; it never falls
back (the caller decides: `rows_take`, `qk_rows_take`). On CPU tensors it
checks the same operands and takes the plain version. The kernels hold a
row in registers, G threads a row, by `ops/act_quant.row_plan`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from .act_quant import MAX_LN_WIDTH, row_plan

MAX_WIDTH = MAX_LN_WIDTH  # the widest row the register classes hold (12288)
_MODE = {"plain": 0, "affine": 1, "modulate": 2}

_ARGTYPES_LN = (
    [ctypes.c_void_p] * 4                      # x, out, p0 (shift or weight), p1
    + [ctypes.c_longlong] * 2                  # modulation batch, frame strides
    + [ctypes.c_int] * 4                       # M, C, rows per batch, frame_seq
    + [ctypes.c_float] + [ctypes.c_int] * 3    # eps, mode, G, chunks
    + [ctypes.c_void_p]                        # stream
)
_ARGTYPES_RMS = (
    [ctypes.c_void_p] * 6                      # x0, x1, out0, out1, w0, w1
    + [ctypes.c_longlong]                      # row stride of the inputs
    + [ctypes.c_void_p] * 2                    # cos, sin
    + [ctypes.c_longlong]                      # batch stride of the tables
    + [ctypes.c_int] * 5                       # M, C, rows per batch, head_dim, inputs
    + [ctypes.c_float] + [ctypes.c_int] * 2    # eps, G, chunks
    + [ctypes.c_void_p]                        # stream
)


def _lib():
    lib = _build.load_library("row_norm")
    if lib.inferix_row_ln.argtypes is None:
        lib.inferix_row_ln.argtypes = _ARGTYPES_LN
        lib.inferix_row_ln.restype = ctypes.c_int
        lib.inferix_row_rms_rope.argtypes = _ARGTYPES_RMS
        lib.inferix_row_rms_rope.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _row_stride(x: torch.Tensor) -> Optional[int]:
    """The stride between the rows of x [..., C] when every row is that far
    from the one before (a contiguous tensor, or columns of a wider one),
    else None."""
    if x.stride(-1) != 1:
        return None
    stride = x.stride(-2) if x.dim() > 1 else x.shape[-1]
    expect = stride
    for d in range(x.dim() - 2, -1, -1):
        if x.shape[d] > 1 and x.stride(d) != expect:
            return None
        expect *= x.shape[d]
    return stride


def rows_take(x: torch.Tensor, *weights: Optional[torch.Tensor]) -> bool:
    """True when the row kernels take x: a contiguous, 16-byte aligned CUDA
    bfloat16 tensor whose width is a positive multiple of 8 up to MAX_WIDTH,
    with bfloat16 weights (None: none)."""
    c = x.shape[-1]
    return (x.is_cuda and x.dtype == torch.bfloat16 and 0 < c <= MAX_WIDTH and c % 8 == 0
            and x.is_contiguous() and _aligned(x)
            and all(w is None or w.dtype == torch.bfloat16 for w in weights))


def qk_rows_take(q: torch.Tensor, k: torch.Tensor, head_dim: int,
                 *weights: torch.Tensor) -> bool:
    """True when the RMS + rope kernel takes q and k [B, S, C] in one launch:
    CUDA bfloat16 views of one shape with evenly strided rows (a multiple of
    8 elements apart, the same for both) and 16-byte aligned bases, a width
    as `rows_take` takes it, head_dim a multiple of 8, bfloat16 weights."""
    c = q.shape[-1]
    stride = _row_stride(q)
    return (q.is_cuda and q.dtype == k.dtype == torch.bfloat16 and q.shape == k.shape
            and 0 < c <= MAX_WIDTH and c % 8 == 0 and head_dim % 8 == 0 and c % head_dim == 0
            and stride is not None and stride % 8 == 0 and _row_stride(k) == stride
            and _aligned(q) and _aligned(k)
            and all(w.dtype == torch.bfloat16 for w in weights))


def rope_cos_sin(angles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope's f32 tables from its angles [S, D/2] (or [B, S, D/2]): the
    same `torch.cos` and `torch.sin` as `apply_rope`, taken once a forward."""
    return torch.cos(angles), torch.sin(angles)


# -- plain versions -------------------------------------------------------------


def ln_rows_reference(x: torch.Tensor, eps: float, weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the LayerNorm row kernel. x [B, S, C] (or [M, C]
    without modulation). f32 statistics, (x - mean) * rsqrt(var + eps); then
    the affine weight and bias in f32 and one cast, or the cast and the
    per-frame modulate in x's dtype: h * dtype(1 + scale) + dtype(shift),
    each operation rounded, with shift / scale [B, F, C] f32 and S = F *
    frame_seq tokens frame-major."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    h = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    if weight is not None:
        h = h * weight.float() + bias.float()
    h = h.to(x.dtype)
    if shift is None:
        return h
    b, s, c = x.shape
    f = shift.shape[1]
    h = h.reshape(b, f, s // f, c)
    sc = (1.0 + scale[:, :, None, :]).to(x.dtype)
    return (h * sc + shift[:, :, None, :].to(x.dtype)).reshape(b, s, c)


def _rope_pairs(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                head_dim: int) -> torch.Tensor:
    """The kernel's rope of y [B, S, C] (bf16) over heads of head_dim, pair
    by pair: (y0 c - y1 s, y1 c + y0 s) in f32, cast back."""
    b, s, c = y.shape
    yf = y.float().reshape(b, s, c // head_dim, head_dim // 2, 2)
    y0, y1 = yf[..., 0], yf[..., 1]
    cs, sn = cos[..., :, None, :], sin[..., :, None, :]
    out = torch.stack([y0 * cs + (-y1) * sn, y1 * cs + y0 * sn], dim=-1)
    return out.reshape(b, s, c).to(y.dtype)


def rms_rows_reference(xs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                       eps: float, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       head_dim: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain version of the RMS (+ rope) row kernel: each x [B, S, C] normed
    over its row in f32, dtype(x * rsqrt(mean(x^2) + eps)) * dtype(w); with
    rope (cos, sin [S, D/2] or [B, S, D/2] f32), each head's pairs rotated
    in f32 and cast back. Returns contiguous [B, S, C] tensors."""
    outs = []
    for x, w in zip(xs, weights):
        xf = x.float()
        y = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(x.dtype) \
            * w.to(x.dtype)
        outs.append(y if rope is None else _rope_pairs(y, *rope, head_dim))
    return tuple(outs)


# -- the kernels -------------------------------------------------------------------


def _check_rows(x: torch.Tensor, dims: int, contiguous: bool = True) -> None:
    """What the kernels read: bfloat16, `dims`-d, 16-byte aligned, a width
    that is a positive multiple of 8 up to MAX_WIDTH (16-byte loads, rows in
    registers), and contiguous (contiguous=False: evenly strided rows, a
    multiple of 8 elements apart)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the row kernels take bfloat16, got {x.dtype}")
    stride = _row_stride(x) if x.dim() == dims else None
    ok = x.is_contiguous() if contiguous else stride is not None and stride % 8 == 0
    if x.dim() != dims or not ok or not _aligned(x):
        raise ValueError(f"x must be a {'contiguous' if contiguous else 'evenly row-strided'} "
                         f"{dims}-d tensor with a 16-byte aligned base, got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    c = x.shape[-1]
    if c <= 0 or c % 8 or c > MAX_WIDTH:
        raise ValueError(f"the row kernels need a width that is a positive multiple of 8 "
                         f"up to {MAX_WIDTH}, got {c}")


def _check_vector(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    c = x.shape[-1]
    if t.device != x.device or t.dtype != torch.bfloat16 or t.numel() != c \
            or not t.is_contiguous() or not _aligned(t):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned [{c}] bfloat16 "
                         f"tensor on {x.device}")


def _check_modulation(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> None:
    b, s, c = x.shape
    if shift.shape != scale.shape or shift.dim() != 3 \
            or shift.shape[0] != b or shift.shape[2] != c:
        raise ValueError(f"shift/scale must be [B={b}, F, C={c}], got "
                         f"{tuple(shift.shape)} and {tuple(scale.shape)}")
    f = shift.shape[1]
    if f == 0 or s % f:
        raise ValueError(f"S = {s} is not a multiple of the {f} frames")
    for name, t in (("shift", shift), ("scale", scale)):
        if t.device != x.device or t.dtype != torch.float32 or t.stride(2) != 1:
            raise ValueError(f"{name} must be float32 on {x.device} with a contiguous C axis")
    if shift.stride()[:2] != scale.stride()[:2]:
        raise ValueError("shift and scale must share their strides")


def _check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ln_rows(x: torch.Tensor, eps: float, weight: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pass of LayerNorm -> bf16 over x's rows, then the per-frame
    modulate (shift / scale [B, F, C] f32, which may be strided views such as
    slices of the [B, F, 6, C] modulation, with a contiguous C axis; x [B, S,
    C]) or the affine weight and bias ([C] bf16), or neither. On CUDA
    tensors this launches the kernel and counts it in `ln_rows.launches`; on
    CPU tensors it takes the plain version."""
    if (weight is None) != (bias is None) or (shift is None) != (scale is None):
        raise ValueError("the LayerNorm takes weight with bias and shift with scale")
    if weight is not None and shift is not None:
        raise ValueError("the LayerNorm takes the affine step or the modulate, not both")
    if shift is not None:
        _check_rows(x, 3)
        _check_modulation(x, shift, scale)
    else:
        _check_rows(x, x.dim())
        for name, t in (("weight", weight), ("bias", bias)):
            if t is not None:
                _check_vector(name, t, x)
    if not x.is_cuda:
        return ln_rows_reference(x, eps, weight, bias, shift, scale)
    c = x.shape[-1]
    m = x.numel() // c
    out = torch.empty_like(x)
    if m == 0:
        return out
    if m > 2**31 - 1:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")
    g, nc = row_plan(c)
    if shift is not None:
        s, f = x.shape[1], shift.shape[1]
        p0, p1, sb, sf, rpb, fs, mode = shift, scale, shift.stride(0), shift.stride(1), s, \
            s // f, "modulate"
    else:
        p0, p1, sb, sf, rpb, fs = weight, bias, 0, 0, m, m
        mode = "plain" if weight is None else "affine"
    with torch.cuda.device(x.device):
        err = _lib().inferix_row_ln(
            x.data_ptr(), out.data_ptr(), None if p0 is None else p0.data_ptr(),
            None if p1 is None else p1.data_ptr(), sb, sf, m, c, rpb, fs, float(eps),
            _MODE[mode], g, nc, torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, f"ln_rows ({mode})")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0


def rms_rows(xs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor], eps: float,
             rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             head_dim: int = 0) -> Tuple[torch.Tensor, ...]:
    """One pass of RMS norm -> bf16 times the weight over the rows of each
    of `xs` (one or two [B, S, C] tensors of one shape and row stride, such
    as q and k, column views of the fused qkv output), then with rope
    (cos, sin f32 [S, head_dim / 2], or [B, S, head_dim / 2] one a stream)
    each head's pairs rotated. Returns contiguous [B, S, C] tensors. On CUDA
    tensors this launches the kernel (both inputs in one launch) and counts
    it in `rms_rows.launches`; on CPU tensors it takes the plain version."""
    if not 1 <= len(xs) <= 2 or len(weights) != len(xs):
        raise ValueError(f"rms_rows takes one or two inputs with a weight each, got "
                         f"{len(xs)} and {len(weights)}")
    x = xs[0]
    for t in xs:
        _check_rows(t, 3, contiguous=False)
        if t.shape != x.shape or _row_stride(t) != _row_stride(x) or t.device != x.device:
            raise ValueError("the inputs must share their shape, row stride and device")
    for w in weights:
        _check_vector("weight", w, x)
    b, s, c = x.shape
    if rope is not None:
        cos, sin = rope
        half = head_dim // 2
        if head_dim <= 0 or head_dim % 8 or c % head_dim:
            raise ValueError(f"the rope needs a head_dim that is a multiple of 8 and "
                             f"divides {c}, got {head_dim}")
        if cos.shape != sin.shape or cos.shape[-2:] != (s, half) \
                or cos.dim() not in (2, 3) or (cos.dim() == 3 and cos.shape[0] != b):
            raise ValueError(f"cos / sin must be [{s}, {half}] or [{b}, {s}, {half}], got "
                             f"{tuple(cos.shape)} and {tuple(sin.shape)}")
        for name, t in (("cos", cos), ("sin", sin)):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() \
                    or not _aligned(t):
                raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 "
                                 f"tensor on {x.device}")
    if not x.is_cuda:
        return rms_rows_reference(xs, weights, eps, rope, head_dim)
    outs = tuple(torch.empty(b, s, c, dtype=x.dtype, device=x.device) for _ in xs)
    m = b * s
    if m == 0:
        return outs
    if m > 2**31 - 1:
        raise ValueError(f"M = {m} exceeds the kernel's grid limit")
    g, nc = row_plan(c)
    two = len(xs) == 2
    cos, sin = rope if rope is not None else (None, None)
    tab_sb = s * (head_dim // 2) if rope is not None and cos.dim() == 3 else 0
    with torch.cuda.device(x.device):
        err = _lib().inferix_row_rms_rope(
            x.data_ptr(), xs[1].data_ptr() if two else None, outs[0].data_ptr(),
            outs[1].data_ptr() if two else None, weights[0].data_ptr(),
            weights[1].data_ptr() if two else None, _row_stride(x),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            tab_sb, m, c, s, head_dim if rope is not None else 0, len(xs), float(eps), g, nc,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, "rms_rows")
    rms_rows.launches += 1
    return outs


rms_rows.launches = 0
