"""KV cache for the semi-AR loop (port of `inferix_tpu/kvcache/cache.py`).

One preallocated buffer per field, `k/v: [L, B, S, H, D]` in the token-major
`bshd` layout, written in place into the block's slots and attended with the
validity mask `slot < current_end`. Where the JAX package threads an
immutable cache through its functions, the port updates these buffers in
place and returns the same tensors.

Two window regimes, as in the JAX package:
- global window (`ring=False`): slots are logical positions;
- rolling window (`ring=True`, `local_attn_size != -1`): the first
  `sink_tokens` slots are pinned, and a position past the window goes to
  `sink + (pos - sink) % ring_tokens`, overwriting the oldest token of the
  ring. The mask `slot < min(current_end, S)` is then exactly the set of
  live tokens, so eviction moves no data.

Three storage types:
- the model dtype (bf16 on the card);
- int8 (`quantized=True`): int8 K/V with one float32 scale per (token,
  head) in `k_scale`/`v_scale` `[L, B, S, H]`, scale = max(absmax / 127,
  1e-8);
- fp8 (`dtype=torch.float8_e4m3fn`): scale-free e4m3 K/V, each value
  clipped to +-448 before the cast.
The head-major layout and the padded allocation of the JAX package exist
for TPU reasons (a transpose copy and the Pallas kv_block pad) that the CUDA
kernels do not have; they are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.device import resolve_device
from ..ops.act_quant import quantize_rows_int8

FP8_MAX = 448.0  # the largest finite e4m3fn value


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static geometry of a model's self-attention cache."""

    num_layers: int
    batch: int
    max_tokens: int      # S: window cap in tokens (32760 = 21 frames at 1.3B)
    num_kv_heads: int
    head_dim: int
    sink_tokens: int = 0  # pinned prefix (sink_size frames * frame_seq)
    ring: bool = False    # True iff rolling window (local_attn_size != -1)
    dtype: torch.dtype = torch.bfloat16
    quantized: bool = False  # int8 K/V + per-(token, head) f32 scales
    # Ring-write granule in tokens (the Wan pipeline writes whole frames):
    # when a write's length and the ring and sink sizes are multiples of it,
    # a block wraps only at granule boundaries and is written as one
    # contiguous copy per granule.
    granule: int = 0

    @property
    def ring_tokens(self) -> int:
        return self.max_tokens - self.sink_tokens


class KVCache(NamedTuple):
    """k/v [L, B, S, H, D]; with a quantized spec k/v are int8 and
    k_scale/v_scale [L, B, S, H] float32 hold their scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_kv_cache(spec: KVCacheSpec, device: str | torch.device = "cuda") -> KVCache:
    shape = (spec.num_layers, spec.batch, spec.max_tokens, spec.num_kv_heads,
             spec.head_dim)
    device = resolve_device(device)
    if spec.quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=spec.dtype, device=device),
                   v=torch.zeros(shape, dtype=spec.dtype, device=device))


def quantize_kv_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, n, H, D] -> (int8 codes [B, n, H, D], scale [B, n, H] f32).

    The arithmetic of per-token activation quantization over each (token,
    head) row of D values, so it runs as the act-quant kernel
    (`quantize_rows_int8`, act None) on a [B*n*H, D] view of a CUDA tensor,
    and as its plain version on the CPU."""
    b, n, h, d = x.shape
    q, s = quantize_rows_int8(x.reshape(b * n * h, d))
    return q.reshape(b, n, h, d), s.reshape(b, n, h)


def position_to_slot(spec: KVCacheSpec, pos):
    """Logical token position(s) -> cache slot(s): the position itself in
    the global window and before the ring first wraps; afterwards
    sink + (pos - sink) % ring_tokens. Takes an int or an int tensor."""
    if not spec.ring:
        return pos
    wrapped = spec.sink_tokens + (pos - spec.sink_tokens) % spec.ring_tokens
    if isinstance(pos, torch.Tensor):
        return torch.where(pos < spec.max_tokens, pos, wrapped)
    return pos if pos < spec.max_tokens else wrapped


def _to_storage(new: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:
        # e4m3fn has no inf: clip to the finite range, or overflow is nan
        return new.float().clamp(-FP8_MAX, FP8_MAX).to(dtype)
    return new.to(dtype)


def _write_row(spec: KVCacheSpec, cache: torch.Tensor, new: torch.Tensor,
               start: int) -> None:
    """Write new [b, n, ...] into cache [b, S, ...] at logical position
    start, in place."""
    n = new.shape[1]
    if not spec.ring:
        if start < 0 or start + n > spec.max_tokens:
            raise ValueError(
                f"block [{start}, {start + n}) does not fit the "
                f"{spec.max_tokens}-slot global window")
        cache[:, start:start + n].copy_(new)
        return
    g = spec.granule
    if g > 0 and n % g == 0 and spec.ring_tokens % g == 0 \
            and spec.sink_tokens % g == 0 and start % g == 0:
        # granule-aligned: each granule is contiguous in slot space
        for i in range(0, n, g):
            slot = position_to_slot(spec, start + i)
            cache[:, slot:slot + g].copy_(new[:, i:i + g])
        return
    pos = torch.arange(start, start + n, device=cache.device)
    cache[:, position_to_slot(spec, pos)] = new


def _write_one(spec: KVCacheSpec, cache: torch.Tensor, new: torch.Tensor,
               current_start) -> torch.Tensor:
    """Write new [B, n, ...] into one layer's cache [B, S, ...] at logical
    position current_start, in place. current_start is an int (every batch
    row at one position) or a [B] tensor or sequence (one position a row)."""
    new = _to_storage(new, cache.dtype)
    if isinstance(current_start, int):
        _write_row(spec, cache, new, current_start)
        return cache
    starts = torch.as_tensor(current_start).reshape(-1).tolist()
    if len(starts) == 1:
        _write_row(spec, cache, new, int(starts[0]))
        return cache
    if len(starts) != cache.shape[0]:
        raise ValueError(f"{len(starts)} starts for a batch of {cache.shape[0]}")
    for i, s0 in enumerate(starts):
        _write_row(spec, cache[i:i + 1], new[i:i + 1], int(s0))
    return cache


def write_block(spec: KVCacheSpec, k_cache: torch.Tensor,
                v_cache: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, current_start,
                k_scale_cache: Optional[torch.Tensor] = None,
                v_scale_cache: Optional[torch.Tensor] = None):
    """Write a block of new tokens [B, n, H, D] into one layer's cache
    [B, S, H, D] at logical position current_start (int, or [B]), in place.

    Returns the (same) layer buffers: (k, v), or (k, v, k_scale, v_scale)
    when the spec is quantized, whose K/V are quantized on the way in."""
    if spec.quantized:
        k_q, k_s = quantize_kv_block(k_new)
        v_q, v_s = quantize_kv_block(v_new)
        return (_write_one(spec, k_cache, k_q, current_start),
                _write_one(spec, v_cache, v_q, current_start),
                _write_one(spec, k_scale_cache, k_s, current_start),
                _write_one(spec, v_scale_cache, v_s, current_start))
    return (_write_one(spec, k_cache, k_new, current_start),
            _write_one(spec, v_cache, v_new, current_start))


def valid_mask(spec: KVCacheSpec, current_end,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Which slots hold live tokens once positions [0, current_end) have
    been written: [S] bool for an int end, [B, S] for a [B] tensor (each
    stream its own live prefix)."""
    dev = resolve_device(device)
    idx = torch.arange(spec.max_tokens, dtype=torch.int32, device=dev)
    if isinstance(current_end, int):
        return idx < min(current_end, spec.max_tokens)
    end = torch.as_tensor(current_end, device=dev).to(torch.int32)
    end = torch.clamp(end, max=spec.max_tokens)
    if end.dim() == 1:
        return idx[None, :] < end[:, None]
    return idx < end


class CrossAttnCache(NamedTuple):
    """Per-layer projected text K/V, computed once per prompt; for an i2v
    model also the CLIP image tokens' K/V."""

    k: torch.Tensor  # [L, B, text_len, H, D]
    v: torch.Tensor  # [L, B, text_len, H, D]
    k_img: Optional[torch.Tensor] = None  # [L, B, 257, H, D]
    v_img: Optional[torch.Tensor] = None
