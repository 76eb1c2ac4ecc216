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
Two layouts, as in the JAX package (both off by default):
- head-major (`head_major=True`): `k/v: [L, B, H, S, D]`, scales
  `[L, B, H, S]`. The writes and the attention read a layer through its
  token-major view (`token_major`: `[B, S, H, D]` with a token stride of D
  elements and a head stride of S*D), so the CUDA kernels, which take every
  operand by its strides, read the layer in place;
- padded (`alloc_tokens`): `slots >= max_tokens` rows a layer. Slots past
  the logical window are never written and never attended; all ring and
  position arithmetic stays on `max_tokens`.

Every write goes run by run (`slot_runs`): the block's positions split into
the pieces that are contiguous in slot space (one in the global window, one
more each time a ring wraps), each one copy. A rank that holds a slice of
the slots (the sequence-parallel ring modes) writes the pieces that fall in
its slice (`slot_range`).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

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
    # [L, B, H, S, D] storage (scales [L, B, H, S]) instead of [L, B, S, H, D]
    head_major: bool = False
    # Physical slots a layer (0: max_tokens); slots past max_tokens are
    # never written and never attended
    alloc_tokens: int = 0

    def __post_init__(self):
        if self.alloc_tokens and self.alloc_tokens < self.max_tokens:
            raise ValueError(f"alloc_tokens ({self.alloc_tokens}) must be 0 or >= "
                             f"max_tokens ({self.max_tokens})")

    @property
    def slots(self) -> int:
        """Physical cache rows a layer (>= max_tokens)."""
        return self.alloc_tokens or self.max_tokens

    @property
    def ring_tokens(self) -> int:
        return self.max_tokens - self.sink_tokens


def padded_tokens(max_tokens: int, multiple: int) -> int:
    """`alloc_tokens` for a window of max_tokens padded to `multiple` (0:
    no padding)."""
    return -(-max_tokens // multiple) * multiple if multiple else 0


class KVCache(NamedTuple):
    """k/v [L, B, S, H, D] ([L, B, H, S, D] head-major); with a quantized
    spec k/v are int8 and k_scale/v_scale [L, B, S, H] ([L, B, H, S])
    float32 hold their scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def cache_shape(spec: KVCacheSpec, num_kv_heads: Optional[int] = None,
                slots: Optional[int] = None) -> Tuple[int, ...]:
    """The K/V fields' shape (the scales drop the last axis); num_kv_heads /
    slots override the head and slot counts (a rank's shard of a
    sequence-parallel cache)."""
    h = spec.num_kv_heads if num_kv_heads is None else num_kv_heads
    s = spec.slots if slots is None else slots
    inner = (h, s) if spec.head_major else (s, h)
    return (spec.num_layers, spec.batch) + inner + (spec.head_dim,)


def init_kv_cache(spec: KVCacheSpec, device: str | torch.device = "cuda",
                  num_kv_heads: Optional[int] = None,
                  slots: Optional[int] = None) -> KVCache:
    """Zeroed buffers of `cache_shape` for `spec`."""
    shape = cache_shape(spec, num_kv_heads, slots)
    device = resolve_device(device)
    if spec.quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=spec.dtype, device=device),
                   v=torch.zeros(shape, dtype=spec.dtype, device=device))


def token_major(t: torch.Tensor, head_major: bool, axis: int = 1) -> torch.Tensor:
    """A cache tensor as a view with the token axis at `axis` and the heads
    after it: a head-major layer [B, H, S, D] (or scales [B, H, S]) becomes
    [B, S, H, D] ([B, S, H]) without a copy; `axis=2` for a whole cache
    [L, B, H, S, ...]. Token-major tensors are returned as they are."""
    return t.transpose(axis, axis + 1) if head_major else t


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


def slot_runs(spec: KVCacheSpec, start: int, n: int,
              slot_range: Optional[Tuple[int, int]] = None) -> List[Tuple[int, int, int]]:
    """The positions [start, start + n) as (offset in the block, slot,
    length) pieces, each contiguous in slot space, in write order: consecutive
    positions take consecutive slots until the ring wraps at max_tokens.
    With slot_range (lo, hi) only the parts in slots [lo, hi) are kept, and
    their slots counted from lo (a rank's slice of the slots)."""
    if not spec.ring:
        if start < 0 or start + n > spec.max_tokens:
            raise ValueError(f"block [{start}, {start + n}) does not fit the "
                             f"{spec.max_tokens}-slot global window")
        runs = [(0, start, n)]
    else:
        runs, i = [], 0
        while i < n:
            slot = position_to_slot(spec, start + i)
            length = min(n - i, spec.max_tokens - slot)
            runs.append((i, slot, length))
            i += length
    if slot_range is None:
        return runs
    lo, hi = slot_range
    clipped = []
    for off, slot, length in runs:
        a, b = max(slot, lo), min(slot + length, hi)
        if a < b:
            clipped.append((off + a - slot, a - lo, b - a))
    return clipped


def _to_storage(new: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:
        # e4m3fn has no inf: clip to the finite range, or overflow is nan
        return new.float().clamp(-FP8_MAX, FP8_MAX).to(dtype)
    return new.to(dtype)


def _starts(current_start, batch: int) -> List[Tuple[slice, int]]:
    """(batch rows, start) pairs: one for an int (or one-element) start, one
    a row for a [B] tensor or sequence."""
    if isinstance(current_start, int):
        return [(slice(None), current_start)]
    starts = torch.as_tensor(current_start).reshape(-1).tolist()
    if len(starts) == 1:
        return [(slice(None), int(starts[0]))]
    if len(starts) != batch:
        raise ValueError(f"{len(starts)} starts for a batch of {batch}")
    return [(slice(i, i + 1), int(s0)) for i, s0 in enumerate(starts)]


def block_fields(spec: KVCacheSpec, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A block's K/V [B, n, H, D] as the rows the cache stores, token-major:
    (k, v), or (k codes, v codes, k_scale, v_scale) for an int8 cache (its
    rows quantized through `quantize_kv_block`)."""
    if spec.quantized:
        k_q, k_s = quantize_kv_block(k_new)
        v_q, v_s = quantize_kv_block(v_new)
        return k_q, v_q, k_s, v_s
    return _to_storage(k_new, spec.dtype), _to_storage(v_new, spec.dtype)


def write_fields(spec: KVCacheSpec, layer: Tuple[torch.Tensor, ...],
                 new: Tuple[torch.Tensor, ...], current_start,
                 slot_range: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, ...]:
    """Copy `block_fields` rows [B, n, ...] into one layer's fields (layout
    `spec.head_major`) at logical position current_start (int, or [B]), in
    place, piece by piece (`slot_runs`). slot_range: the layer holds only
    slots [lo, hi) (a rank's slice). Returns the same layer tensors."""
    n = new[0].shape[1]
    for rows, s0 in _starts(current_start, new[0].shape[0]):
        runs = slot_runs(spec, s0, n, slot_range)
        for field, rows_new in zip(layer, new):
            view = token_major(field, spec.head_major)[rows]
            src = _to_storage(rows_new[rows], field.dtype)
            for off, slot, length in runs:
                view[:, slot:slot + length].copy_(src[:, off:off + length])
    return tuple(layer)


def write_block(spec: KVCacheSpec, k_cache: torch.Tensor,
                v_cache: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, current_start,
                k_scale_cache: Optional[torch.Tensor] = None,
                v_scale_cache: Optional[torch.Tensor] = None):
    """Write a block of new tokens [B, n, H, D] into one layer's cache
    ([B, S, H, D], or [B, H, S, D] head-major) at logical position
    current_start (int, or [B]), in place.

    Returns the (same) layer buffers: (k, v), or (k, v, k_scale, v_scale)
    when the spec is quantized, whose K/V are quantized on the way in."""
    layer = (k_cache, v_cache) + ((k_scale_cache, v_scale_cache) if spec.quantized else ())
    return write_fields(spec, layer, block_fields(spec, k_new, v_new), current_start)


def live_tokens(spec: KVCacheSpec, current_end):
    """How many slots hold live tokens once positions [0, current_end)
    have been written: an int for an int end, a [B] CPU tensor for [B]."""
    if isinstance(current_end, int):
        return min(current_end, spec.max_tokens)
    return torch.as_tensor(current_end, device="cpu").to(torch.long).clamp(max=spec.max_tokens)


def valid_mask(spec: KVCacheSpec, current_end,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Which slots hold live tokens once positions [0, current_end) have
    been written: [slots] bool for an int end, [B, slots] for a [B] tensor
    (each stream its own live prefix)."""
    dev = resolve_device(device)
    idx = torch.arange(spec.slots, dtype=torch.int32, device=dev)
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
