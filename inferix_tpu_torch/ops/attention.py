"""Attention ops (port of `inferix_tpu/ops/attention.py`): the plain masked
reference, the chunked online-softmax version, the log-sum-exp merge of
partial results (`merge_attention_partials`), and the `cache_attention`
dispatcher the model calls for both self-attention over the KV cache and
cross-attention over the text keys.

All variants return (out, lse) with out [B, Sq, H, D] in q.dtype and
lse [B, H, Sq] float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import FP8, flash_attention, flash_attention_quant


def _bhqd(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)


def _mask_logits(logits: torch.Tensor,
                 kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if kv_mask is None:
        return logits
    m = kv_mask if kv_mask.dim() == 2 else kv_mask[None, :]
    return logits.masked_fill(~m[:, None, None, :], float("-inf"))


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked attention with fp32 logits and softmax. kv_mask: [B, Skv]
    or [Skv] bool, True = attend. O(Sq*Skv) memory."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(_bhqd(q).float(), _bhqd(k).float().transpose(-1, -2))
    logits = _mask_logits(logits * scale, kv_mask)
    lse = torch.logsumexp(logits, dim=-1)
    # fully masked rows give (-inf) - (-inf) = nan: zero them
    probs = torch.nan_to_num(torch.exp(logits - lse[..., None]))
    out = torch.matmul(probs.to(v.dtype), _bhqd(v))
    return _bhqd(out).to(q.dtype), lse


def attention_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    chunk_size: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention over KV chunks; O(Sq*chunk) memory. Same
    contract as attention_reference, which it is for Skv <= chunk_size."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if skv <= chunk_size:
        return attention_reference(q, k, v, kv_mask, scale)
    if kv_mask is None:
        kv_mask = torch.ones(b, skv, dtype=torch.bool, device=q.device)
    elif kv_mask.dim() == 1:
        kv_mask = kv_mask[None, :].expand(b, skv)
    qf = _bhqd(q).float()
    acc = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h, sq), float("-inf"), device=q.device)
    l_run = torch.zeros(b, h, sq, device=q.device)
    for c0 in range(0, skv, chunk_size):
        kk = _bhqd(k[:, c0:c0 + chunk_size])
        vv = _bhqd(v[:, c0:c0 + chunk_size])
        logits = torch.matmul(qf, kk.float().transpose(-1, -2)) * scale
        logits = _mask_logits(logits, kv_mask[:, c0:c0 + chunk_size])
        m_new = torch.maximum(m_run, logits.amax(-1))
        corr = torch.nan_to_num(torch.exp(torch.where(
            torch.isfinite(m_run), m_run - m_new,
            torch.full_like(m_run, float("-inf")))))
        p = torch.nan_to_num(torch.exp(logits - m_new[..., None]))
        l_run = l_run * corr + p.sum(-1)
        pv = torch.matmul(p.to(vv.dtype).float(), vv.float())
        acc = acc * corr[..., None] + pv
        m_run = m_new
    denom = torch.clamp(l_run, min=1e-30)
    out = acc / denom[..., None]
    return _bhqd(out).to(q.dtype), m_run + torch.log(denom)


def merge_attention_partials(
    outs: torch.Tensor, lses: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge N partial attention results with the log-sum-exp trick.
    outs [N, B, Sq, H, D], lses [N, B, H, Sq] -> (out [B, Sq, H, D] in
    outs.dtype, lse [B, H, Sq])."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    denom = w.sum(dim=0)
    w_t = (w / denom[None]).transpose(2, 3)[..., None]      # [N, B, Sq, H, 1]
    out = (outs.float() * w_t).sum(dim=0)
    return out.to(outs.dtype), m + torch.log(denom)


def cache_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    logical_kv: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_layout: str = "bshd",
) -> torch.Tensor:
    """Dispatcher: the hand-written CUDA flash kernels for self-attention
    over a long cache on the card, plain tensor ops otherwise.

    k_scale/v_scale ([B, Skv, H] f32) mark k/v as an int8 cache: on CUDA
    tensors it always goes to `flash_attention_quant` (the int8-KV kernel,
    in-kernel dequantization); elsewhere it is dequantized to q.dtype and
    attended on the plain path, as the JAX package's XLA fallback does. An
    e4m3 cache (scale-free) goes to the kernel like a bf16 one, and is cast
    to q.dtype on the plain paths. On CUDA tensors, attention over more
    than 1024 keys (or with a logits tensor past 256 MiB) goes to
    `flash_attention`, which launches the kernel on the live prefix of
    `kv_mask`. Smaller attention (cross-attention over the 512 text tokens)
    stays plain matmul + softmax, as the JAX package keeps it in fused XLA
    ops. On the CPU every call takes the plain path.

    kv_layout "bhsd": k/v [B, H, Skv, D] and the scales [B, H, Skv] come
    from a head-major cache layer; every path reads them through their
    token-major views (`k.transpose(1, 2)`), the kernels by strides, with
    no copy.
    """
    if kv_layout not in ("bshd", "bhsd"):
        raise ValueError(f"kv_layout must be 'bshd' or 'bhsd', got {kv_layout!r}")
    if kv_layout == "bhsd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if k_scale is not None:
            k_scale, v_scale = k_scale.transpose(1, 2), v_scale.transpose(1, 2)
    if k_scale is not None and q.is_cuda:
        return flash_attention_quant(q, k, v, k_scale, v_scale,
                                     kv_mask=kv_mask, scale=scale)
    skv = k.shape[1] if logical_kv is None else logical_kv
    logits_bytes = 4 * q.shape[0] * q.shape[2] * q.shape[1] * skv
    if q.is_cuda and (skv > 1024 or logits_bytes > 256 * 2**20):
        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    # logical_kv: the cache's logical window when its allocation is padded.
    # Slots past it are never valid; the plain paths slice them off so their
    # chunking (and with it the reduction order) matches an exact-size cache.
    if logical_kv is not None and logical_kv < k.shape[1]:
        k, v = k[:, :logical_kv], v[:, :logical_kv]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, :logical_kv], v_scale[:, :logical_kv]
        if kv_mask is not None:
            kv_mask = kv_mask[..., :logical_kv]
    if k_scale is not None:
        # dequantize, then attend
        k = (k.float() * k_scale[..., None].float()).to(q.dtype)
        v = (v.float() * v_scale[..., None].float()).to(q.dtype)
    elif k.dtype == FP8:
        k, v = k.to(q.dtype), v.to(q.dtype)
    if q.is_cuda:
        return attention_reference(q, k, v, kv_mask=kv_mask, scale=scale)[0]
    return attention_chunked(q, k, v, kv_mask=kv_mask, scale=scale)[0]
