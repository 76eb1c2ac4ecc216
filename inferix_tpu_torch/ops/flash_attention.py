"""Prefix-span flash attention: the wrappers of the hand-written CUDA
kernels (`csrc/flash_attention_prefix.cu`) and their plain PyTorch versions.

Port of `inferix_tpu/ops/flash_attention.py`:
- `flash_attention_prefix` (`:204`, TPU kernel `_flash_kernel` `:53`) and its
  mask wrapper `flash_attention` (`:358`), over a bf16 or a scale-free fp8
  e4m3 K/V cache (the TPU kernel casts e4m3 K/V to q's dtype, `:126`,
  `:142`);
- `flash_attention_prefix_quant` (`:497`, TPU kernel `_flash_kernel_quant`
  `:390`) over an int8 K/V cache with one float32 scale per (token, head),
  dequantized inside the kernel by scaling the logits' columns by k_scale
  and the probabilities' columns by v_scale.
q [B, Sq, H, D] attends over the span [kv_start, kv_len) of k/v
[B, Skv, H, D]; the bounds may be ints, 0-d tensors or [B] tensors (one span
per batch row).

On CUDA tensors each wrapper launches its kernel or raises; it never falls
back. On CPU tensors it takes its plain version, which repeats the kernel's
arithmetic in plain tensor ops.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 128  # the only head dim the CUDA kernel is built for
_NEG_INF = -1e30
_SOFTMAX = ("fixedm", "runmax")
FP8 = torch.float8_e4m3fn
# K/V storage types of flash_attention_prefix, by the kernel's code for them
_KV_KIND = {torch.bfloat16: 0, FP8: 1}


def _row_values(x, b: int) -> list:
    """Per-row bound as Python ints (host read: the plain version only)."""
    t = torch.as_tensor(x).reshape(-1)
    if t.numel() not in (1, b):
        raise ValueError(f"a span bound must be a scalar or [{b}], got {tuple(t.shape)}")
    return (t.expand(b) if t.numel() == 1 else t).tolist()


def _bounds_tensor(kv_start, kv_len, b: int, device) -> torch.Tensor:
    """[B, 2] int32 (kv_start, kv_end) on the device, built without a host
    sync: ints become a device fill, tensors stay where they are."""
    cols = []
    for x in (kv_start, kv_len):
        if isinstance(x, torch.Tensor):
            t = x.to(device=device, dtype=torch.int32).reshape(-1)
            if t.numel() not in (1, b):
                raise ValueError(
                    f"a span bound must be a scalar or [{b}], got {tuple(x.shape)}")
            cols.append(t.expand(b))
        else:
            cols.append(torch.full((b,), int(x), dtype=torch.int32, device=device))
    return torch.stack(cols, dim=1).contiguous()


def _attend_reference(q, k, v, kv_len, kv_start, scale, softmax, return_lse,
                      k_scale=None, v_scale=None):
    """The plain versions' shared loop over batch rows and heads, so that a
    full-cache call holds one head's logits at a time."""
    if softmax not in _SOFTMAX:
        raise ValueError(f"softmax must be 'fixedm' or 'runmax', got {softmax}")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    starts, ends = _row_values(kv_start, b), _row_values(kv_len, b)
    for i in range(b):
        s0, e0 = max(int(starts[i]), 0), min(int(ends[i]), skv)
        e0 = max(e0, s0)
        for hh in range(h):
            kk = k[i, s0:e0, hh].float()                       # [n, D]
            vv = v[i, s0:e0, hh]
            s = qs[i, :, hh] @ kk.T                            # [Sq, n]
            if k_scale is not None:
                s = s * k_scale[i, s0:e0, hh].float()[None, :]
            if softmax == "runmax":
                m = torch.clamp(s.amax(-1, keepdim=True), min=_NEG_INF) \
                    if e0 > s0 else torch.full((sq, 1), _NEG_INF, device=q.device)
                p = torch.exp2(s - m)
            else:
                m = None
                p = torch.exp2(s)
            denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
            if v_scale is None:
                pv = p.to(v.dtype)
            else:
                pv = (p * v_scale[i, s0:e0, hh].float()[None, :]).to(torch.bfloat16)
            acc = pv.float() @ vv.float()                      # [Sq, D]
            out[i, :, hh] = (acc / denom).to(q.dtype)
            e = torch.log2(denom) if m is None else m + torch.log2(denom)
            lse[i, hh] = (e / LOG2E)[:, 0]
    return (out, lse) if return_lse else out


def flash_attention_prefix_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, kv_start=0,
    scale: Optional[float] = None, softmax: str = "fixedm",
    return_lse: bool = False,
):
    """Plain PyTorch version of the kernel, with the kernel's arithmetic:
    e4m3 K/V cast to q.dtype (exact); q pre-scaled by scale*log2(e) and
    rounded to q.dtype; fp32 logits; p = exp2(s) (fixedm) or exp2(s -
    rowmax) (runmax) with masked columns at -1e30; p rounded to v.dtype for
    the PV product, fp32 accumulation; the denominator max(l, 1e-30); the
    LSE converted back by /log2(e)."""
    if k.dtype == FP8:
        k, v = k.to(q.dtype), v.to(q.dtype)
    return _attend_reference(q, k, v, kv_len, kv_start, scale, softmax,
                             return_lse)


def flash_attention_prefix_quant_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, kv_start=0, scale: Optional[float] = None,
    softmax: str = "fixedm", return_lse: bool = False,
):
    """Plain PyTorch version of the int8-KV kernel (`_flash_kernel_quant`'s
    arithmetic): int8 K/V widened exactly; fp32 logits q . k scaled column
    by column by k_scale; exp2 with q pre-scaled by scale*log2(e); l sums
    the unscaled p; p * v_scale rounded to bf16 (whatever q's dtype) before
    the PV product; the 1e-30 floor. k_scale/v_scale: [B, Skv, H] f32."""
    return _attend_reference(q, k, v, kv_len, kv_start, scale, softmax,
                             return_lse, k_scale, v_scale)


_STRIDES = [ctypes.c_longlong] * 3           # (batch, seq, head) strides
_ARGTYPES = (
    [ctypes.c_void_p] * 6                  # q, k, v, out, lse, bounds
    + [ctypes.c_int] * 4                   # B, H, Sq, Skv
    + _STRIDES * 4                         # q, k, v, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)                                          # q_scale, runmax, kv kind, stream
_ARGTYPES_QUANT = (
    [ctypes.c_void_p] * 8                  # q, k, v, k_scale, v_scale, out, lse, bounds
    + [ctypes.c_int] * 4                   # B, H, Sq, Skv
    + _STRIDES * 6                         # q, k, v, k_scale, v_scale, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # q_scale, runmax, stream
)


def _lib():
    lib = _build.load_library("flash_attention_prefix")
    if lib.inferix_flash_attention_prefix.argtypes is None:
        lib.inferix_flash_attention_prefix.argtypes = _ARGTYPES
        lib.inferix_flash_attention_prefix.restype = ctypes.c_int
        lib.inferix_flash_attention_prefix_quant.argtypes = _ARGTYPES_QUANT
        lib.inferix_flash_attention_prefix_quant.restype = ctypes.c_int
    return lib


def _check_cuda_operands(q, k, v, kv_dtypes):
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on the same CUDA device")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16 for the CUDA kernel, got {q.dtype}")
    if k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise TypeError(f"k and v must share one of {kv_dtypes} for the CUDA "
                        f"kernel, got {k.dtype} and {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"{name} must be [B, S, H, {HEAD_DIM}], got {tuple(t.shape)}")
        # 16-byte vector loads: a contiguous head dim, 16-byte aligned rows
        per16 = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous head dim, 16-byte aligned base and "
                f"strides that are multiples of {per16} elements; got strides "
                f"{t.stride()}")
    b, _, h, _ = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid limit")


def _outputs(q, return_lse):
    b, sq, h, d = q.shape
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    return out, lse


def _check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_prefix(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, kv_start=0,
    scale: Optional[float] = None, softmax: str = "fixedm",
    return_lse: bool = False,
):
    """Flash attention of q over the span [kv_start, kv_len) of k/v.

    Returns out [B, Sq, H, D] in q.dtype, and lse [B, H, Sq] float32 when
    return_lse. softmax='fixedm' (default) is max-free and exact while
    |natural logit| <~ 60; 'runmax' keeps a running max. On CUDA tensors this
    launches the hand-written kernel (bf16 q; bf16 or e4m3 K/V, D = 128) and
    counts the launch in `flash_attention_prefix.launches` (bf16 K/V) or
    `flash_attention_prefix.launches_fp8` (e4m3 K/V); on CPU tensors it takes
    the plain version. The kernel reads q, k and v through their strides: a
    cache layer `cache.k[l]` ([B, S, H, D], contiguous) goes in as it is,
    with no transpose or padding copy (the TPU path pays one per layer).
    """
    if softmax not in _SOFTMAX:
        raise ValueError(f"softmax must be 'fixedm' or 'runmax', got {softmax}")
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("q, k and v must lie on one device")
        return flash_attention_prefix_reference(
            q, k, v, kv_len, kv_start, scale, softmax, return_lse)
    _check_cuda_operands(q, k, v, tuple(_KV_KIND))
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    bounds = _bounds_tensor(kv_start, kv_len, b, q.device)
    out, lse = _outputs(q, return_lse)
    if sq > 0:
        with torch.cuda.device(q.device):
            err = _lib().inferix_flash_attention_prefix(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None, bounds.data_ptr(),
                b, h, sq, k.shape[1],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3],
                scale * LOG2E, int(softmax == "runmax"), _KV_KIND[k.dtype],
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _check_launch(err, "flash_attention_prefix")
        if k.dtype == FP8:
            flash_attention_prefix.launches_fp8 += 1
        else:
            flash_attention_prefix.launches += 1
    return (out, lse) if return_lse else out


flash_attention_prefix.launches = 0
flash_attention_prefix.launches_fp8 = 0


def flash_attention_prefix_quant(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, kv_start=0, scale: Optional[float] = None,
    softmax: str = "fixedm", return_lse: bool = False,
):
    """Flash attention of q over the span [kv_start, kv_len) of an int8 K/V
    cache with float32 scales k_scale/v_scale [B, Skv, H], dequantized in
    the kernel. Same contract as `flash_attention_prefix` otherwise. On CUDA
    tensors this launches the int8-KV kernel (bf16 q, D = 128) and counts
    the launch in `flash_attention_prefix_quant.launches`; on CPU tensors
    it takes the plain version. The scales are read through their strides
    (a cache layer's `k_scale[l]` as it is)."""
    if softmax not in _SOFTMAX:
        raise ValueError(f"softmax must be 'fixedm' or 'runmax', got {softmax}")
    if not q.is_cuda:
        if any(t.is_cuda for t in (k, v, k_scale, v_scale)):
            raise ValueError("q, k, v and the scales must lie on one device")
        return flash_attention_prefix_quant_reference(
            q, k, v, k_scale, v_scale, kv_len, kv_start, scale, softmax,
            return_lse)
    _check_cuda_operands(q, k, v, (torch.int8,))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != tuple(k.shape[:3]):
            raise ValueError(f"{name} must be float32 {tuple(k.shape[:3])} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    bounds = _bounds_tensor(kv_start, kv_len, b, q.device)
    out, lse = _outputs(q, return_lse)
    if sq > 0:
        with torch.cuda.device(q.device):
            err = _lib().inferix_flash_attention_prefix_quant(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None, bounds.data_ptr(),
                b, h, sq, k.shape[1],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *k_scale.stride(), *v_scale.stride(), *out.stride()[:3],
                scale * LOG2E, int(softmax == "runmax"),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _check_launch(err, "flash_attention_prefix_quant")
        flash_attention_prefix_quant.launches += 1
    return (out, lse) if return_lse else out


flash_attention_prefix_quant.launches = 0


def _mask_len(k: torch.Tensor, kv_mask: Optional[torch.Tensor]):
    """The span end of a prefix mask: its population count, reduced on the
    device ([B] for a [B, S] mask)."""
    if kv_mask is None:
        return k.shape[1]
    return kv_mask.sum(dim=-1, dtype=torch.int32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Mask-based wrapper (the `cache_attention` contract). The mask must be
    a prefix mask, as every cache-validity mask is; its population count is
    the span's end."""
    return flash_attention_prefix(q, k, v, _mask_len(k, kv_mask), scale=scale)


def flash_attention_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Mask-based wrapper of `flash_attention_prefix_quant`."""
    return flash_attention_prefix_quant(q, k, v, k_scale, v_scale,
                                        _mask_len(k, kv_mask), scale=scale)
