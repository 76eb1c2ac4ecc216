"""KV cache for the semi-AR loop (port of `inferix_tpu/kvcache/cache.py`).

This slice ports the bf16 cache in the token-major `bshd` layout with the
global window: one preallocated buffer per field, `k/v: [L, B, S, H, D]`,
written in place with `copy_` into the block's slots and attended with the
validity mask `slot < current_end`. Where the JAX package threads an
immutable cache through its functions, the port updates these buffers in
place and returns the same `KVCache`. The int8 cache, the head-major layout
and the rolling window are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static geometry of a model's self-attention cache."""

    num_layers: int
    batch: int
    max_tokens: int      # S: window cap in tokens (32760 = 21 frames at 1.3B)
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S, H, D]
    v: torch.Tensor  # [L, B, S, H, D]


def init_kv_cache(spec: KVCacheSpec, device: str | torch.device = "cuda") -> KVCache:
    shape = (spec.num_layers, spec.batch, spec.max_tokens, spec.num_kv_heads,
             spec.head_dim)
    device = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=spec.dtype, device=device),
                   v=torch.zeros(shape, dtype=spec.dtype, device=device))


def position_to_slot(spec: KVCacheSpec, pos: int) -> int:
    """Logical token position -> cache slot. With the global window the
    slots are the positions."""
    return pos


def write_block(spec: KVCacheSpec, k_cache: torch.Tensor,
                v_cache: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, current_start: int):
    """Write a block of new tokens [B, n, H, D] into one layer's cache
    [B, S, H, D] at logical position current_start, in place. Returns the
    (same) layer buffers."""
    n = k_new.shape[1]
    slot = position_to_slot(spec, current_start)
    if slot < 0 or slot + n > spec.max_tokens:
        raise ValueError(
            f"block [{current_start}, {current_start + n}) does not fit the "
            f"{spec.max_tokens}-slot global window")
    k_cache[:, slot:slot + n].copy_(k_new)
    v_cache[:, slot:slot + n].copy_(v_new)
    return k_cache, v_cache


def valid_mask(spec: KVCacheSpec, current_end: int,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """[S] bool: which slots hold live tokens once positions
    [0, current_end) have been written."""
    idx = torch.arange(spec.max_tokens, dtype=torch.int32,
                       device=resolve_device(device))
    return idx < min(current_end, spec.max_tokens)


class CrossAttnCache(NamedTuple):
    """Per-layer projected text K/V, computed once per prompt."""

    k: torch.Tensor  # [L, B, text_len, H, D]
    v: torch.Tensor  # [L, B, text_len, H, D]
