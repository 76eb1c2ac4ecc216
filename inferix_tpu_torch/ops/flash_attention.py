"""Prefix-span flash attention: the wrappers of the hand-written CUDA
kernels (`csrc/flash_attention_sm90.cu`: wgmma and TMA, one instantiation
each for bf16, e4m3 and int8 K/V, and the int8-PV kernels over int8 K/V)
and their plain PyTorch versions.

Port of `inferix_tpu/ops/flash_attention.py`:
- `flash_attention_prefix` (`:204`, TPU kernel `_flash_kernel` `:53`) and its
  mask wrapper `flash_attention` (`:358`), over a bf16 or a scale-free fp8
  e4m3 K/V cache (the TPU kernel casts e4m3 K/V to q's dtype, `:126`,
  `:142`);
- `flash_attention_prefix_quant` (`:497`, TPU kernel `_flash_kernel_quant`
  `:390`) over an int8 K/V cache with one float32 scale per (token, head),
  dequantized inside the kernel by scaling the logits' columns by k_scale
  and the probabilities' columns by v_scale.
- `flash_attention_prefix_quant_i8` (`:740`, TPU kernel
  `_flash_kernel_quant_i8` `:660`) and `flash_attention_prefix_quant_v2`
  (`:1039`, `_flash_kernel_quant_v2` `:962`): int8 PV on codes of p per kv
  group (below).
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
import torch.nn.functional as F

from .. import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 128  # the only head dim the CUDA kernel is built for
_NEG_INF = -1e30
_SOFTMAX = ("fixedm", "runmax")
FP8 = torch.float8_e4m3fn
# K/V storage types, by the kernel's code for them: flash_attention_prefix
# takes the first two, flash_attention_prefix_quant the third
_KV_KIND = {torch.bfloat16: 0, FP8: 1, torch.int8: 2}


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
_ARGTYPES_SM90 = (
    [ctypes.c_void_p] * 10                 # q, k, v, k_scale, v_scale, out, lse,
                                           # bounds, ws, counters
    + [ctypes.c_int] * 6                   # B, H, Sq, Skv, n_full, tail_splits
    + _STRIDES * 6                         # q, k, v, k_scale, v_scale, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)                                          # q_scale, runmax, kv kind, stream
_TMA_MAX_STRIDE = 1 << 40
BLOCK_Q = 128        # q rows of one CTA: a unit is (batch*head, q tile)
_MAX_SPLITS = 4      # pieces of a tail unit at most (the kernel's limit)
_WS_FLOATS = 256 * 68  # workspace floats of one piece: O, l and m a thread


def tail_split(units: int, sms: int) -> tuple:
    """(n_full, splits) for a launch of `units` CTAs, one an SM: the units of
    the whole rounds run whole, and each unit of the last, partial round
    runs as `splits` pieces of its span (as many as fit on the SMs that
    round would leave idle, at most 4). E.g. 444 units on 132 SMs: 396
    whole and 48 in 2 pieces, 3.5 rounds' time instead of 4."""
    tail = units % sms
    splits = min(_MAX_SPLITS, sms // tail) if tail else 1
    return (units - tail, splits) if splits > 1 else (units, 1)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib_sm90():
    fn = _build.load_library("flash_attention_sm90").inferix_flash_attention_sm90
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_SM90
        fn.restype = ctypes.c_int
    return fn


def check_tma_kv(name: str, t: torch.Tensor) -> None:
    """The rule of the kernel's K/V tensor maps, on a [B, Skv, H, 128]
    tensor of bf16 values or 1-byte codes: a contiguous head dim, a 16-byte
    aligned base, and batch, token and head strides that are positive
    multiples of 16 bytes below 2^40 (TMA's rule for its global strides; 8
    elements in bf16); at least one token. A cache layer slice (token
    stride H*128 elements) qualifies; a broadcast (zero) stride does not.
    Raises ValueError otherwise; the wrapper never falls back."""
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM or t.shape[1] == 0:
        raise ValueError(f"{name} must be [B, Skv > 0, H, {HEAD_DIM}], got {tuple(t.shape)}")
    es = t.element_size()
    strides = [s * es for s in t.stride()[:3]]
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s <= 0 or s % 16 or s >= _TMA_MAX_STRIDE for s in strides):
        raise ValueError(
            f"{name}: the kernel's tensor map needs a contiguous head dim, a "
            f"16-byte aligned base and batch/token/head strides that are "
            f"positive multiples of 16 bytes; got byte strides {strides}")


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


def _launch_sm90(name, q, k, v, k_scale, v_scale, kv_len, kv_start, scale,
                 softmax, return_lse):
    """Check the K/V against the tensor maps' rule and launch the kernel's
    instantiation for k.dtype; returns (out, lse or None)."""
    check_tma_kv("k", k)
    check_tma_kv("v", v)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    bounds = _bounds_tensor(kv_start, kv_len, b, q.device)
    out, lse = _outputs(q, return_lse)
    if sq == 0:
        return out, lse
    units = -(-sq // BLOCK_Q) * b * h
    n_full, splits = tail_split(units, _sm_count(q.device))
    pieces = (units - n_full) * splits
    ws = counters = None
    if pieces:
        ws = torch.empty(pieces * _WS_FLOATS, dtype=torch.float32, device=q.device)
        counters = torch.zeros(units - n_full, dtype=torch.int32, device=q.device)
    scales = (k_scale, v_scale) if k_scale is not None else None
    with torch.cuda.device(q.device):
        err = _lib_sm90()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *((t.data_ptr() for t in scales) if scales else (None, None)),
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            bounds.data_ptr(), ws.data_ptr() if ws is not None else None,
            counters.data_ptr() if counters is not None else None,
            b, h, sq, k.shape[1], n_full, splits,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *(k_scale.stride() if scales else (0, 0, 0)),
            *(v_scale.stride() if scales else (0, 0, 0)), *out.stride()[:3],
            scale * LOG2E, int(softmax == "runmax"), _KV_KIND[k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(err, name)
    return out, lse


def flash_attention_prefix(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, kv_start=0,
    scale: Optional[float] = None, softmax: str = "fixedm",
    return_lse: bool = False,
):
    """Flash attention of q over the span [kv_start, kv_len) of k/v.

    Returns out [B, Sq, H, D] in q.dtype, and lse [B, H, Sq] float32 when
    return_lse. softmax='fixedm' (default) is max-free and exact while
    |natural logit| <~ 60; 'runmax' keeps a running max. On CUDA tensors this
    launches the hand-written kernel (`csrc/flash_attention_sm90.cu`: wgmma,
    TMA; bf16 q; bf16 or e4m3 K/V as `check_tma_kv` states, D = 128) and
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
    _check_cuda_operands(q, k, v, (torch.bfloat16, FP8))
    out, lse = _launch_sm90("flash_attention_prefix", q, k, v, None, None, kv_len,
                            kv_start, scale, softmax, return_lse)
    if q.shape[1] > 0:
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
    tensors this launches the int8-KV kernel (`csrc/flash_attention_sm90.cu`:
    wgmma, TMA; bf16 q, D = 128; k/v as `check_tma_kv` states) and counts
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
    out, lse = _launch_sm90("flash_attention_prefix_quant", q, k, v, k_scale, v_scale,
                            kv_len, kv_start, scale, softmax, return_lse)
    if q.shape[1] > 0:
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


# ---------------------------------------------------------------------------
# Int8-PV attention over an int8 K/V cache: the int8-QK variant (TPU kernel 3)
# and the bf16-QK variant (TPU kernel 4), whose numerics depend on the kv
# group (`kv_block`) over which p is quantized
# ---------------------------------------------------------------------------

DEFAULT_KV_BLOCK = 2048
_QUANT_EXT_MODES = ("i8", "v2")


def _kv_group(kv_block: Optional[int], skv: int) -> int:
    """The JAX package's kv group: min(kv_block or 2048, max(128,
    ceil(Skv / 128) * 128))."""
    g = DEFAULT_KV_BLOCK if kv_block is None else int(kv_block)
    if g <= 0:
        raise ValueError(f"kv_block must be positive, got {kv_block}")
    return min(g, max(128, -(-skv // 128) * 128))


def _true_div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b as one correctly rounded division (PyTorch divides by a Python
    number, and a Python number by a tensor, through a reciprocal)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=torch.float32, device=a.device)
    if not isinstance(a, torch.Tensor):
        a = torch.full((), float(a), dtype=torch.float32, device=b.device)
    return a / b


def quantize_q_int8(q: torch.Tensor, scale: float):
    """The int8-QK wrapper's per-(token, head) quantization of q (JAX
    `flash_attention.py:777-783`): absmax = max(max |q|, 1e-8) over D,
    codes round(q * (127 / absmax)) clipped to +-127, and a row scale
    (absmax / 127) * (scale * log2(e)) that folds the dequantization, the
    softmax scale and the exp2 domain. Returns (q_i8 [B, Sq, H, D] int8,
    q_scale [B, Sq, H] f32), contiguous."""
    qf = q.float()
    absmax = torch.clamp_min(qf.abs().amax(dim=-1, keepdim=True), 1e-8)
    q_i8 = torch.clamp(torch.round(qf * _true_div(127.0, absmax)), -127, 127)
    qs = _true_div(absmax, 127.0) * (scale * LOG2E)
    return q_i8.to(torch.int8).contiguous(), qs[..., 0].contiguous()


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed exactly (float64) and rounded once to float32: the
    int8 products' int32 sums (|sum| < 2^53), and bf16 or int8 products."""
    return torch.matmul(a.double(), b.double()).float()


def quant_ext_reference(mode, q, k_q, v_q, k_scale, v_scale, kv_len, scale,
                         kv_block, return_lse, on_group=None):
    """The plain version of both int8-PV kernels (mode "i8": TPU kernel 3,
    "v2": TPU kernel 4), group by group; one batch row at a time holds
    [H, Sq, group] tensors only. on_group(i, g0, g1, u,
    m, deq), when given, sees each group's unrounded code values u [H, Sq,
    g1 - g0] (the codes are round(u); keys g0..g1 of batch row i), the
    running max m [H, Sq, 1] they were formed against and the step deq that
    dequantizes the group's PV sums."""
    if mode not in _QUANT_EXT_MODES:
        raise ValueError(f"mode must be one of {_QUANT_EXT_MODES}, got {mode}")
    b, sq, h, d = q.shape
    skv = k_q.shape[1]
    if scale is None:
        scale = d ** -0.5
    grp = _kv_group(kv_block, skv)
    if mode == "i8":
        q_i8, qs = quantize_q_int8(q, scale)
        qh, qsh = q_i8.permute(0, 2, 1, 3), qs.permute(0, 2, 1)[..., None]
    else:
        qh = (q.float() * (scale * LOG2E)).to(q.dtype).permute(0, 2, 1, 3)
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    ends = _row_values(kv_len, b)
    for i in range(b):
        end = min(max(int(ends[i]), 0), skv)
        m = torch.full((h, sq, 1), _NEG_INF, device=q.device)
        l = torch.zeros(h, sq, 1, device=q.device)
        acc = torch.zeros(h, sq, d, device=q.device)
        for g0 in range(0, end, grp):
            g1 = min(g0 + grp, end)                      # live keys of the group
            kk = k_q[i, g0:g1].permute(1, 0, 2)           # [H, n, D]
            ks = k_scale[i, g0:g1].permute(1, 0).float()[:, None, :]
            vs = v_scale[i, g0:g1].permute(1, 0).float()[:, None, :]
            s = _exact_matmul(qh[i], kk.transpose(1, 2))   # [H, Sq, n]
            s = (s * qsh[i] * ks) if mode == "i8" else s * ks
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            if mode == "i8":
                p_v = p * vs
                row_max = torch.clamp_min(p_v.amax(-1, keepdim=True), 1e-20)
                u = p_v * _true_div(127.0, row_max)
                deq = _true_div(row_max, 127.0)
            else:
                # the group's max V scale, over every key of the group in
                # the cache (past kv_len too), as the TPU kernel takes it
                vsb = torch.clamp_min(
                    v_scale[i, g0:min(g0 + grp, skv)].float().amax(0), 1e-20)
                vsb = vsb[:, None, None]
                u = p * (vs * _true_div(127.0, vsb))
                deq = _true_div(vsb, 127.0)
            if on_group is not None:
                on_group(i, g0, g1, u, m_new, deq)
            pv = _exact_matmul(torch.round(u), v_q[i, g0:g1].permute(1, 0, 2)) * deq
            acc = acc * corr + pv
            m = m_new
        denom = torch.clamp_min(l, 1e-30)
        out[i] = _true_div(acc, denom).to(q.dtype).permute(1, 0, 2)
        lse[i] = _true_div(m + torch.log2(denom), LOG2E)[..., 0]
    return (out, lse) if return_lse else out


def flash_attention_prefix_quant_i8_reference(
    q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, scale: Optional[float] = None,
    kv_block: Optional[int] = None, return_lse: bool = False,
):
    """Plain version of the int8-QK kernel (`_flash_kernel_quant_i8`'s
    arithmetic): q quantized per (token, head) (`quantize_q_int8`); logits
    f32(q_i8 . k_q) * q_scale * k_scale in that order; per kv group (the
    kernel's `kv_block`) the running max takes in the whole group before
    p = exp2(s - m) is formed, p_v = p * v_scale is requantized against the
    row's max over the group, max(max p_v, 1e-20): codes round(p_v * (127 /
    row_max)), half to even; the group's int32 PV times row_max / 127; the
    1e-30 floor. Keys past kv_len are masked (p = 0)."""
    return quant_ext_reference("i8", q, k_q, v_q, k_scale, v_scale, kv_len,
                                scale, kv_block, return_lse)


def flash_attention_prefix_quant_v2_reference(
    q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, scale: Optional[float] = None,
    kv_block: Optional[int] = None, return_lse: bool = False,
):
    """Plain version of the int8-PV kernel (`_flash_kernel_quant_v2`'s
    arithmetic): q pre-scaled by scale*log2(e) and rounded to q.dtype; f32
    logits (q . k_q) * k_scale; per kv group the running max takes in the
    whole group, vsb = max(the group's largest v_scale, 1e-20), codes
    round(p * (v_scale * (127 / vsb))), half to even; the group's int32 PV
    times vsb / 127; the 1e-30 floor. Keys past kv_len are masked (p = 0)."""
    return quant_ext_reference("v2", q, k_q, v_q, k_scale, v_scale, kv_len,
                                scale, kv_block, return_lse)


_ARGTYPES_QUANT_SM90 = (
    [ctypes.c_void_p] * 9                  # q, k, vt, rows, deq, out, lse, kv_len,
                                           # codes
    + [ctypes.c_int] * 6                   # B, H, Sq, Skv, kv group, deq groups
    + _STRIDES * 3                         # q, k, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # q_scale, mode, stream
)
_ARGTYPES_OPERANDS = (
    [ctypes.c_void_p] * 4                  # k, v, vt, kb
    + [ctypes.c_int] * 3                   # B, H, Skv
    + _STRIDES * 2 + [ctypes.c_void_p]     # k, v strides; stream
)


def _lib_quant_sm90():
    fn = _build.load_library("flash_attention_sm90").inferix_flash_attention_quant_sm90
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_QUANT_SM90
        fn.restype = ctypes.c_int
    return fn


def _lib_quant_operands():
    fn = _build.load_library("flash_attention_sm90").inferix_quant_operands
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_OPERANDS
        fn.restype = ctypes.c_int
    return fn


def pv_operand(v_q: torch.Tensor) -> torch.Tensor:
    """The int8 PV product's B operand (s8 wgmma reads it K-major): V
    [B, Skv, H, D] transposed to [B, H, D, n32] (n32 = Skv rounded up to 32,
    zero keys past Skv), with its keys permuted within each 32-key chunk into
    the order in which a thread's codes sit in the QK accumulator, so that
    the codes go from the accumulator straight into the PV A fragments:
    key' = 16 h + 4 t + c holds key 16 h + 8 (c >> 1) + 2 t + (c & 1)
    (h < 2, t < 4, c < 4). One strided copy, once a call."""
    b, skv, h, d = v_q.shape
    n32 = -(-skv // 32) * 32
    if n32 != skv:
        v_q = F.pad(v_q, (0, 0, 0, 0, 0, n32 - skv))
    x = v_q.reshape(b, n32 // 32, 2, 2, 4, 2, h, d)  # key = 16 h + 8 c1 + 2 t + c0
    return x.permute(0, 6, 7, 1, 2, 4, 3, 5).reshape(b, h, d, n32)


def quant_ext_rows(mode: str, k_scale: torch.Tensor, v_scale: torch.Tensor, grp: int):
    """The kernel's per-key rows [B, H, R, n32] float32 (zero past Skv) and,
    for "v2", deq [B, H, ceil(Skv / grp)]: "i8" rows k_scale, v_scale and
    log2(v_scale) (the last only picks each row's candidate key for the
    group's max of p * v_scale); "v2" rows k_scale and v_scale * (127 / vsb),
    with vsb = max(the group's largest v_scale in the cache, 1e-20) and deq =
    vsb / 127, each the plain version's own float32 operation."""
    b, skv, h = k_scale.shape
    n32 = -(-skv // 32) * 32
    ks, vs = k_scale.float(), v_scale.float()
    deq = None
    if mode == "i8":
        per_key = (ks, vs, torch.log2(vs))
    else:
        ng = -(-skv // grp)
        vsb = torch.clamp_min(
            F.pad(vs, (0, 0, 0, ng * grp - skv)).view(b, ng, grp, h).amax(2), 1e-20)
        ratio = _true_div(127.0, vsb).repeat_interleave(grp, dim=1)[:, :skv]
        per_key = (ks, vs * ratio)
        deq = _true_div(vsb, 127.0).permute(0, 2, 1).contiguous()
    rows = torch.zeros(b, h, len(per_key), n32, dtype=torch.float32, device=k_scale.device)
    rows[..., :skv] = torch.stack(per_key, dim=2).permute(0, 3, 2, 1)
    return rows, deq


def quant_operands(k_q: torch.Tensor, v_q: torch.Tensor, widen_k: bool):
    """The int8-PV kernels' operand layouts, once a call: (vt, kb) with vt =
    `pv_operand(v_q)` and kb = k_q widened to bf16 [B, Skv, H, D] contiguous
    (widen_k, for "v2"; else None). On CUDA tensors one launch of the
    pre-pass kernel of `csrc/flash_attention_sm90.cu` (k_q/v_q as
    `check_tma_kv` states); on CPU tensors the plain versions."""
    b, skv, h, d = v_q.shape
    if not v_q.is_cuda:
        return pv_operand(v_q), (k_q.to(torch.bfloat16).contiguous() if widen_k else None)
    vt = torch.empty(b, h, d, -(-skv // 32) * 32, dtype=torch.int8, device=v_q.device)
    kb = torch.empty(b, skv, h, d, dtype=torch.bfloat16, device=v_q.device) if widen_k else None
    with torch.cuda.device(v_q.device):
        err = _lib_quant_operands()(
            k_q.data_ptr(), v_q.data_ptr(), vt.data_ptr(),
            kb.data_ptr() if kb is not None else None, b, h, skv,
            *k_q.stride()[:3], *v_q.stride()[:3],
            torch.cuda.current_stream(v_q.device).cuda_stream)
    _check_launch(err, "quant_operands")
    return vt, kb


def quant_ext_kernel(mode: str, q, k_q, v_q, k_scale, v_scale, kv_len,
                     scale=None, kv_block=None, return_lse=False,
                     codes: Optional[torch.Tensor] = None):
    """Launch the int8-PV kernel of `mode` ("i8": TPU kernel 3, "v2": TPU
    kernel 4; `csrc/flash_attention_sm90.cu`, wgmma and TMA) on CUDA tensors;
    raises on an operand it cannot take (k_q and v_q as `check_tma_kv`
    states). Before it, once a call: the operand pre-pass (`quant_operands`)
    and the per-key rows and deq (`quant_ext_rows`); "i8" quantizes q in the
    kernel, as `quantize_q_int8` does. codes, when given ([B, H, Sq, Skv]
    uint8, zeroed), receives every p code the kernel forms (keys past kv_len
    stay 0): the check of the kernel's rounding events on the card; the path
    never passes it. Counts the launch in the mode's wrapper's `launches`."""
    if mode not in _QUANT_EXT_MODES:
        raise ValueError(f"mode must be one of {_QUANT_EXT_MODES}, got {mode}")
    _check_cuda_operands(q, k_q, v_q, (torch.int8,))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != tuple(k_q.shape[:3]):
            raise ValueError(f"{name} must be float32 {tuple(k_q.shape[:3])} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    check_tma_kv("k", k_q)
    check_tma_kv("v", v_q)
    b, sq, h, d = q.shape
    skv = k_q.shape[1]
    grp = _kv_group(kv_block, skv)
    if grp % 64:
        raise ValueError(f"the kernel takes a kv group that is a multiple of 64 keys, "
                         f"got {grp}")
    if scale is None:
        scale = d ** -0.5
    if codes is not None and (codes.dtype != torch.uint8 or not codes.is_contiguous()
                              or tuple(codes.shape) != (b, h, sq, skv)
                              or codes.device != q.device):
        raise ValueError(f"codes must be a contiguous uint8 [{b}, {h}, {sq}, {skv}] "
                         "tensor on q's device")
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device) \
        if return_lse else None
    wrapper = (flash_attention_prefix_quant_i8 if mode == "i8"
               else flash_attention_prefix_quant_v2)
    if sq > 0:
        lens = _bounds_tensor(0, kv_len, b, q.device)[:, 1].contiguous()  # no host sync
        vt, kb = quant_operands(k_q, v_q, mode == "v2")
        kk = k_q if kb is None else kb
        rows, deq = quant_ext_rows(mode, k_scale, v_scale, grp)
        with torch.cuda.device(q.device):
            err = _lib_quant_sm90()(
                q.data_ptr(), kk.data_ptr(), vt.data_ptr(), rows.data_ptr(),
                deq.data_ptr() if deq is not None else None, out.data_ptr(),
                lse.data_ptr() if lse is not None else None, lens.data_ptr(),
                codes.data_ptr() if codes is not None else None,
                b, h, sq, skv, grp, deq.shape[-1] if deq is not None else 0,
                *q.stride()[:3], *kk.stride()[:3], *out.stride()[:3],
                scale * LOG2E, int(mode == "v2"),
                torch.cuda.current_stream(q.device).cuda_stream)
        _check_launch(err, f"flash_attention_prefix_quant_{mode}")
        wrapper.launches += 1
    return (out, lse) if return_lse else out


def _quant_ext(mode, reference, q, k_q, v_q, k_scale, v_scale, kv_len, scale,
               kv_block, return_lse):
    if not q.is_cuda:
        if any(t.is_cuda for t in (k_q, v_q, k_scale, v_scale)):
            raise ValueError("q, k, v and the scales must lie on one device")
        return reference(q, k_q, v_q, k_scale, v_scale, kv_len, scale, kv_block,
                         return_lse)
    return quant_ext_kernel(mode, q, k_q, v_q, k_scale, v_scale, kv_len, scale,
                            kv_block, return_lse)


def flash_attention_prefix_quant_i8(
    q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, scale: Optional[float] = None,
    kv_block: Optional[int] = None, return_lse: bool = False,
):
    """Attention of q [B, Sq, H, D] over the prefix [0, kv_len) of an int8
    K/V cache with float32 scales [B, Skv, H], with both products in int8:
    q quantized per (token, head), p requantized per row and kv group (see
    the plain version). kv_len: an int, a 0-d or a [B] tensor. kv_block: the
    kv group, min(kv_block or 2048, max(128, ceil(Skv / 128) * 128)) as in
    the JAX package. Returns out [B, Sq, H, D] in q.dtype, and lse [B, H,
    Sq] float32 when return_lse. On CUDA tensors this launches the
    hand-written kernel (bf16 q, D = 128) and counts the launch in
    `flash_attention_prefix_quant_i8.launches`; on CPU tensors it takes the
    plain version. No engine path calls it (nor the JAX package's)."""
    return _quant_ext("i8", flash_attention_prefix_quant_i8_reference, q, k_q, v_q,
                      k_scale, v_scale, kv_len, scale, kv_block, return_lse)


flash_attention_prefix_quant_i8.launches = 0


def flash_attention_prefix_quant_v2(
    q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_len, scale: Optional[float] = None,
    kv_block: Optional[int] = None, return_lse: bool = False,
):
    """Attention over an int8 K/V cache with bf16 QK and int8 PV: p
    quantized with the fixed 127 against the kv group's largest V scale (see
    the plain version). Same contract as `flash_attention_prefix_quant_i8`;
    launches are counted in `flash_attention_prefix_quant_v2.launches`."""
    return _quant_ext("v2", flash_attention_prefix_quant_v2_reference, q, k_q, v_q,
                      k_scale, v_scale, kv_len, scale, kv_block, return_lse)


flash_attention_prefix_quant_v2.launches = 0
