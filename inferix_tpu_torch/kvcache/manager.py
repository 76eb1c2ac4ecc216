"""Request-level KV cache manager (port of `inferix_tpu/kvcache/manager.py`).

The device state is one batched cache (`KVCache`, batch axis = slots).
Requests claim batch slots; admitting and retiring concurrent streams reuses
slots without reallocating. Freeing a request zeroes its row; `clear` drops
the whole device cache (free-before-VAE). Host offload copies the cache into
pinned CPU tensors and back.

Where the JAX package donates the cache to jitted updates so that XLA writes
in place, the port writes the buffers in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..core.device import resolve_device
from .cache import KVCache, KVCacheSpec, _to_storage, init_kv_cache, quantize_kv_block


@dataclasses.dataclass
class KVCacheRequest:
    """Handle for one generation stream (reference `KVCacheRequest`)."""

    request_id: str


def _fields(cache: KVCache) -> List[torch.Tensor]:
    return [x for x in cache if x is not None]


class KVCacheManager:
    """Slot allocator over a batched KV cache on one device."""

    def __init__(self, spec: KVCacheSpec, device: str | torch.device = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.max_requests = spec.batch
        self._slots: Dict[str, int] = {}
        self._free_slots = list(range(self.max_requests))
        self._cache: Optional[KVCache] = None
        self._host_cache: Optional[KVCache] = None

    # -- request lifecycle --------------------------------------------------

    def allocate_slots(self, request: KVCacheRequest) -> int:
        """Claim a batch slot for a request (idempotent)."""
        if request.request_id in self._slots:
            return self._slots[request.request_id]
        if not self._free_slots:
            raise RuntimeError(
                f"no free KV cache slots (max {self.max_requests} concurrent "
                f"requests); free() a finished stream first"
            )
        slot = self._free_slots.pop(0)
        self._slots[request.request_id] = slot
        if self._cache is not None:
            self._zero_slot(slot)
        return slot

    def slot_of(self, request: KVCacheRequest) -> int:
        return self._slots[request.request_id]

    def free(self, request: KVCacheRequest) -> None:
        """Retire a request; its slot becomes claimable and its row is zeroed."""
        slot = self._slots.pop(request.request_id, None)
        if slot is None:
            return
        self._free_slots.append(slot)
        if self._cache is not None:
            self._zero_slot(slot)

    def active_requests(self) -> List[str]:
        return list(self._slots)

    # -- cache state --------------------------------------------------------

    @property
    def cache(self) -> KVCache:
        if self._cache is None:
            self._cache = init_kv_cache(self.spec, device=self.device)
        return self._cache

    def update(self, cache: KVCache) -> None:
        """Store the cache a generation step returned."""
        self._cache = cache

    def _zero_slot(self, slot: int) -> None:
        for x in _fields(self._cache):
            x[:, slot].zero_()

    def clear(self) -> None:
        """Free-before-VAE (reference `free`/`clear_cache` choreography,
        `CausalInferencePipeline.py:395-400`): drop the device tensors so the
        VAE decode can use their memory (once no caller holds them)."""
        self._cache = None
        self._host_cache = None

    # -- host offload -------------------------------------------------------

    def offload_to_host(self) -> None:
        """Move the cache to host memory: pinned CPU tensors when it lies on
        the card (reference kv_offload, `kvcache_manager.py:240-242`)."""
        if self._cache is None:
            return
        pin = self.device.type == "cuda"
        host = KVCache(*(None if x is None else
                         torch.empty(x.shape, dtype=x.dtype, pin_memory=pin).copy_(x)
                         for x in self._cache))
        self._host_cache = host
        self._cache = None

    def restore_from_host(self) -> None:
        if self._host_cache is None:
            return
        self._cache = KVCache(*(None if x is None else x.to(self.device)
                                for x in self._host_cache))
        self._host_cache = None

    # -- accounting ---------------------------------------------------------

    def device_bytes(self) -> int:
        if self._cache is None:
            return 0
        return sum(x.numel() * x.element_size() for x in _fields(self._cache))

    # -- reference API-surface parity ---------------------------------------
    # (`inferix/kvcache_manager/kvcache_manager.py:113-221`)

    def free_layer(self, layer_idx: int) -> None:
        """Zero one layer's cache across all slots (the reference's
        layer-by-layer free-before-VAE)."""
        if self._cache is None:
            return
        for x in _fields(self._cache):
            x[layer_idx].zero_()

    def _check_token_axis_api(self, name: str) -> None:
        if getattr(self.spec, "head_major", False):
            raise NotImplementedError(
                f"KVCacheManager.{name} indexes the token axis at position "
                "2; head-major caches are an engine-forward layout — use "
                "head_major=False for token-range slab access (allocation/"
                "free/offload work in either layout)")

    def get_range(self, request: KVCacheRequest, layer_idx: int,
                  start: int, length: int):
        """Read a token range of one request's cache at one layer: (k, v),
        each [length, H, D], copies. Quantized caches are returned
        dequantized (f32): raw int8 without the scales would be meaningless
        to a caller."""
        self._check_token_axis_api("get_range")
        slot = self.slot_of(request)
        c = self.cache
        k = c.k[layer_idx, slot, start:start + length]
        v = c.v[layer_idx, slot, start:start + length]
        if c.k_scale is None:
            return k.clone(), v.clone()
        ks = c.k_scale[layer_idx, slot, start:start + length]
        vs = c.v_scale[layer_idx, slot, start:start + length]
        return k.float() * ks[..., None], v.float() * vs[..., None]

    def set_range(self, request: KVCacheRequest, layer_idx: int,
                  start: int, k_data: torch.Tensor, v_data: torch.Tensor) -> None:
        """Partial write of [length, H, D] into one request's cache (reference
        `set`), in place, cast to the cache's storage type. An int8 cache
        takes the data in the model dtype (`spec.dtype`) and quantizes it per
        (token, head), on the card through the act-quant kernel
        (`quantize_kv_block`), and updates the scale rows too: casting floats
        straight to int8 would truncate them and leave stale scales behind."""
        self._check_token_axis_api("set_range")
        slot = self.slot_of(request)
        c = self.cache
        n = k_data.shape[0]
        if c.k_scale is not None:
            k_q, k_s = quantize_kv_block(k_data.to(self.device, self.spec.dtype)[None])
            v_q, v_s = quantize_kv_block(v_data.to(self.device, self.spec.dtype)[None])
            for buf, new in ((c.k, k_q), (c.v, v_q), (c.k_scale, k_s), (c.v_scale, v_s)):
                buf[layer_idx, slot, start:start + n].copy_(new[0])
            return
        for buf, new in ((c.k, k_data), (c.v, v_data)):
            buf[layer_idx, slot, start:start + n].copy_(
                _to_storage(new.to(self.device), buf.dtype))
