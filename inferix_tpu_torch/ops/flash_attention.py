"""Prefix-span flash attention: the wrapper of the hand-written CUDA kernel
(`csrc/flash_attention_prefix.cu`) and its plain PyTorch version.

Port of `inferix_tpu/ops/flash_attention.py:flash_attention_prefix` (`:204`)
and its mask wrapper `flash_attention` (`:358`). q [B, Sq, H, D] attends over
the span [kv_start, kv_len) of k/v [B, Skv, H, D]; the bounds may be ints,
0-d tensors or [B] tensors (one span per batch row).

On CUDA tensors the wrapper launches the kernel or raises; it never falls
back. On CPU tensors it takes `flash_attention_prefix_reference`, which
repeats the kernel's arithmetic in plain tensor ops.
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


def flash_attention_prefix_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, kv_start=0,
    scale: Optional[float] = None, softmax: str = "fixedm",
    return_lse: bool = False,
):
    """Plain PyTorch version of the kernel, with the kernel's arithmetic: q
    pre-scaled by scale*log2(e) and rounded to q.dtype, fp32 logits, p =
    exp2(s) (fixedm) or exp2(s - rowmax) (runmax) with masked columns at
    -1e30, p rounded to v.dtype for the PV product, fp32 accumulation, the
    denominator max(l, 1e-30), and the LSE converted back by /log2(e). Loops
    over batch rows and heads so that a full-cache call holds one head's
    logits at a time."""
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
            if softmax == "runmax":
                m = torch.clamp(s.amax(-1, keepdim=True), min=_NEG_INF) \
                    if e0 > s0 else torch.full((sq, 1), _NEG_INF, device=q.device)
                p = torch.exp2(s - m)
            else:
                m = None
                p = torch.exp2(s)
            denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
            acc = p.to(v.dtype).float() @ vv.float()           # [Sq, D]
            out[i, :, hh] = (acc / denom).to(q.dtype)
            e = torch.log2(denom) if m is None else m + torch.log2(denom)
            lse[i, hh] = (e / LOG2E)[:, 0]
    return (out, lse) if return_lse else out


_ARGTYPES = (
    [ctypes.c_void_p] * 6                  # q, k, v, out, lse, bounds
    + [ctypes.c_int] * 4                   # B, H, Sq, Skv
    + [ctypes.c_longlong] * 12             # (batch, seq, head) strides of q, k, v, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # q_scale, runmax, stream
)


def _kernel():
    lib = _build.load_library("flash_attention_prefix")
    fn = lib.inferix_flash_attention_prefix
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(q, k, v):
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on the same CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"{name} must be [B, S, H, {HEAD_DIM}], got {tuple(t.shape)}")
        # 16-byte vector loads: a contiguous head dim, 16-byte aligned rows
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous head dim, 16-byte aligned base and "
                f"strides that are multiples of 8 elements; got strides {t.stride()}")
    b, _, h, _ = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid limit")


def flash_attention_prefix(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, kv_start=0,
    scale: Optional[float] = None, softmax: str = "fixedm",
    return_lse: bool = False,
):
    """Flash attention of q over the span [kv_start, kv_len) of k/v.

    Returns out [B, Sq, H, D] in q.dtype, and lse [B, H, Sq] float32 when
    return_lse. softmax='fixedm' (default) is max-free and exact while
    |natural logit| <~ 60; 'runmax' keeps a running max. On CUDA tensors this
    launches the hand-written kernel (bf16, D = 128) and counts the launch in
    `flash_attention_prefix.launches`; on CPU tensors it takes the plain
    version. The kernel reads q, k and v through their strides: a cache layer
    `cache.k[l]` ([B, S, H, D], contiguous) goes in as it is, with no transpose
    or padding copy (the TPU path pays one per layer).
    """
    if softmax not in _SOFTMAX:
        raise ValueError(f"softmax must be 'fixedm' or 'runmax', got {softmax}")
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("q, k and v must lie on one device")
        return flash_attention_prefix_reference(
            q, k, v, kv_len, kv_start, scale, softmax, return_lse)
    _check_cuda_operands(q, k, v)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    bounds = _bounds_tensor(kv_start, kv_len, b, q.device)
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if sq > 0:
        fn = _kernel()
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None, bounds.data_ptr(),
                b, h, sq, k.shape[1],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3],
                scale * LOG2E, int(softmax == "runmax"),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(
                f"flash_attention_prefix kernel launch failed: CUDA error {err}")
        flash_attention_prefix.launches += 1
    return (out, lse) if return_lse else out


flash_attention_prefix.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Mask-based wrapper (the `cache_attention` contract). The mask must be
    a prefix mask, as every cache-validity mask is; its population count,
    reduced on the device, is the span's end."""
    if kv_mask is None:
        kv_len = k.shape[1]
    else:
        kv_len = kv_mask.sum(dim=-1, dtype=torch.int32)
    return flash_attention_prefix(q, k, v, kv_len, scale=scale)
