"""Continuous batching of concurrent generation streams (port of
`inferix_tpu/pipeline/continuous.py`).

Independent streams share one batched denoise step. Each stream holds a
batch slot of the KV cache (`kvcache/manager.py`) and advances at its own
block position: the step passes one start a slot, which gives each row its
rope offset, its cache write position and its live attention span. Admitting
a stream resets its slot and starts it at position 0 while its neighbours go
on mid-clip; an idle slot computes on zeros at position 0 and touches no
other row. Each stream draws its noise and renoise from a generator of its
own, so its trajectory does not depend on the slot it holds or on its
neighbours.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..kvcache.cache import CrossAttnCache
from ..kvcache.manager import KVCacheManager, KVCacheRequest
from .semi_ar import SemiARGenerator


@dataclasses.dataclass
class Stream:
    """One generation request occupying a batch slot."""

    request_id: str
    slot: int
    num_frames: int
    frames_done: int = 0
    generator: Optional[torch.Generator] = None
    outputs: List[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.frames_done >= self.num_frames


class ContinuousBatcher:
    """Admits streams into slots and advances every active stream one block
    a step with one batched denoise call."""

    def __init__(self, generator: SemiARGenerator):
        self.gen = generator
        self.spec = generator.statics.spec
        self.manager = KVCacheManager(self.spec, device=generator.device)
        self.max_streams = self.spec.batch
        self.streams: Dict[str, Stream] = {}
        self._xattn: Optional[CrossAttnCache] = None
        self.fpb = generator.cfg.model.num_frame_per_block

    def set_conditioning(self, xattn: CrossAttnCache) -> None:
        """The batched cross-attention cache of every slot (a slot's prompt
        is its row)."""
        self._xattn = xattn

    def admit(self, request_id: str, num_frames: int, seed: int = 0) -> Stream:
        slot = self.manager.allocate_slots(KVCacheRequest(request_id))
        stream = Stream(request_id=request_id, slot=slot, num_frames=num_frames,
                        generator=torch.Generator(device=self.gen.device).manual_seed(seed))
        self.streams[request_id] = stream
        return stream

    def retire(self, request_id: str) -> Stream:
        stream = self.streams.pop(request_id)
        self.manager.free(KVCacheRequest(request_id))
        return stream

    @property
    def active(self) -> List[Stream]:
        return [s for s in self.streams.values() if not s.finished]

    def step(self) -> List[Tuple[str, torch.Tensor]]:
        """Advance every active stream one block. Returns the (request_id,
        block latents [1, fpb, H, W, C]) pairs of this step."""
        active = self.active
        if not active or self._xattn is None:
            return []
        r = self.gen.cfg.runtime
        b = self.max_streams
        shape = (self.fpb, r.latent_height, r.latent_width, r.latent_channels)
        starts = torch.zeros(b, dtype=torch.long)
        noise = torch.zeros((b,) + shape, dtype=self.gen.dtype, device=self.gen.device)
        generators: List[Optional[torch.Generator]] = [None] * b
        for s in active:
            starts[s.slot] = s.frames_done
            noise[s.slot] = torch.randn(shape, generator=s.generator, dtype=torch.float32,
                                        device=self.gen.device).to(self.gen.dtype)
            generators[s.slot] = s.generator
        x0, cache = self.gen.denoise_block(self.manager.cache, self._xattn, noise,
                                           starts, generator=generators)
        self.manager.update(cache)
        out = []
        for s in active:
            block = x0[s.slot:s.slot + 1]
            s.outputs.append(block)
            s.frames_done += self.fpb
            out.append((s.request_id, block))
        return out
