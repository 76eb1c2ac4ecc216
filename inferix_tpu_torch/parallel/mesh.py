"""The port's mesh: one process a rank over `torch.distributed` (port of
`inferix_tpu/parallel/mesh.py`, its sequence-parallel part).

The JAX package lays one `jax.sharding.Mesh` over its devices and lets GSPMD
place every tensor. The port runs one process a rank, and `SPMesh` holds
what a rank needs: the sequence-parallel process group, the rank, the size,
the backend and the device. The caller names the backend: "nccl" (one rank
a card) or "gloo" (the CPU tests, and several ranks on one card). gloo
exchanges host tensors only, so with gloo and CUDA tensors every exchange
goes through host copies (`host_staging`, counted in `staged_bytes`).

Placement, stated once (the JAX package leaves it to GSPMD):
- outside attention each rank holds the block's tokens `frame_shard`
  gives it: in every frame, the rank's contiguous 1/sp of the frame's
  tokens (the JAX `latent_pspec`, spatial rows over sp). Linears, norms,
  modulation, cross-attention and the FFN run on those tokens only; the
  output head's tokens are gathered back (`gather_frame_shards`), so every
  rank ends a forward with the whole flow;
- the KV cache is sharded as `wan_kv_cache_shard` says (the JAX
  `wan_kv_cache_pspec`): ulysses, each rank a contiguous 1/sp of the heads
  over all slots; the ring modes, each rank a contiguous 1/sp of the slots
  over all heads;
- parameters, text K/V, latents and noise are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.config import ParallelConfig
from ..core.device import resolve_device
from ..kvcache.cache import KVCache, KVCacheSpec, init_kv_cache

BACKENDS = ("nccl", "gloo")
FP8 = torch.float8_e4m3fn


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as the backends take it: contiguous, e4m3 as its bytes."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class SPMesh:
    """A rank's view of the sequence-parallel group. size 1 (`group` None)
    is one device: no island runs and no exchange is made."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    sent_bytes: int = 0     # bytes this rank put on the wire
    staged_bytes: int = 0   # bytes copied card -> host -> card around gloo

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of {self.size}")
        self.device = resolve_device(self.device)

    @property
    def host_staging(self) -> bool:
        """gloo with CUDA tensors: every exchange goes through host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        if self.host_staging:
            self.staged_bytes += _nbytes(t)
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        t = t.view(dtype) if dtype == FP8 else t
        if self.host_staging:
            self.staged_bytes += _nbytes(t)
            return t.to(self.device, non_blocking=True)
        return t

    def _empty_like(self, shape, dtype) -> torch.Tensor:
        dev = "cpu" if self.host_staging else self.device
        return torch.empty(shape, dtype=torch.uint8 if dtype == FP8 else dtype, device=dev)

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """chunks[j] goes to rank j; returns what each rank sent here, in rank
        order (every chunk of one shape and dtype). One `all_to_all_single`
        over the chunks stacked: gloo has no list all-to-all."""
        dtype = chunks[0].dtype
        send = self._out(_wire(torch.stack(list(chunks))))
        recv = self._empty_like(send.shape, dtype)
        self.sent_bytes += _nbytes(send) // self.size * (self.size - 1)
        dist.all_to_all_single(recv, send, group=self.group)
        return list(self._back(recv, dtype).unbind(0))

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's t, in rank order."""
        send = self._out(_wire(t))
        recv = [self._empty_like(t.shape, t.dtype) for _ in range(self.size)]
        self.sent_bytes += _nbytes(send) * (self.size - 1)
        dist.all_gather(recv, send, group=self.group)
        return [self._back(r, t.dtype) for r in recv]

    def ring_shift(self, tensors: Sequence[torch.Tensor],
                   recv_shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
        """Send each tensor to rank + 1 and receive recv_shapes[i] (same
        dtype) from rank - 1, around the ring. A tensor (or shape) with no
        element is not exchanged: both sides know its size."""
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        ops, recv = [], []
        for t, shape in zip(tensors, recv_shapes):
            buf = self._empty_like(shape, t.dtype)
            recv.append(buf)
            if t.numel():
                s = self._out(_wire(t))
                self.sent_bytes += _nbytes(s)
                ops.append(dist.P2POp(dist.isend, s, self._global(nxt), group=self.group))
            if buf.numel():
                ops.append(dist.P2POp(dist.irecv, buf, self._global(prv), group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [self._back(r, t.dtype) for r, t in zip(recv, tensors)]

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def make_mesh(cfg: ParallelConfig, rank: int, backend: str,
              device: str | torch.device = "cuda",
              init_method: Optional[str] = None) -> SPMesh:
    """This rank's mesh for `cfg` (sp ranks; tp = dp = pp = 1, which
    ParallelConfig enforces). Initialises the default process group with
    `backend` from `init_method` ("file://...", "tcp://host:port") when it
    is not initialised yet; the group's world must then be cfg.sp."""
    if cfg.sp == 1:
        return single_device_mesh(device, backend)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=cfg.sp)
    if dist.get_world_size() != cfg.sp or dist.get_rank() != rank:
        raise ValueError(f"the process group has rank {dist.get_rank()} of "
                         f"{dist.get_world_size()}, the mesh wants {rank} of {cfg.sp}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()!r}, "
                         f"the mesh names {backend!r}")
    return SPMesh(rank=rank, size=cfg.sp, backend=backend, device=device)


def single_device_mesh(device: str | torch.device = "cuda", backend: str = "nccl") -> SPMesh:
    return SPMesh(rank=0, size=1, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Where each rank's tokens and cache slice lie
# ---------------------------------------------------------------------------

def frame_shard(mesh: SPMesh, x: torch.Tensor, frames: int, dim: int = 1) -> torch.Tensor:
    """This rank's tokens of x (tokens frame-major on `dim`): in every one of
    the `frames` frames, the rank's contiguous 1/size of the frame's tokens.
    frames=1 gives a contiguous 1/size of the whole sequence."""
    n = x.shape[dim]
    if n % (frames * mesh.size):
        raise ValueError(f"{n} tokens in {frames} frames do not split over sp {mesh.size}")
    c = n // (frames * mesh.size)
    parts = x.unflatten(dim, (frames, mesh.size, c)).select(dim + 1, mesh.rank)
    return parts.flatten(dim, dim + 1)


def unshard_frames(shards: Sequence[torch.Tensor], frames: int, dim: int = 1) -> torch.Tensor:
    """The inverse of `frame_shard`: every rank's tokens (in rank order) back
    in frame-major order."""
    parts = [s.unflatten(dim, (frames, s.shape[dim] // frames)) for s in shards]
    return torch.stack(parts, dim=dim + 1).flatten(dim, dim + 2)


def gather_frame_shards(mesh: SPMesh, x: torch.Tensor, frames: int, dim: int = 1) -> torch.Tensor:
    """Every rank's `frame_shard` of a tensor, back in frame-major order."""
    return unshard_frames(mesh.all_gather(x), frames, dim)


def tokens_to_heads(mesh: SPMesh, x: torch.Tensor, frames: int) -> torch.Tensor:
    """[B, n/sp, H, ...] frame shards -> [B, n, H/sp, ...]: every token of
    the rank's contiguous 1/sp of the heads (one all-to-all)."""
    h = x.shape[2]
    if h % mesh.size:
        raise ValueError(f"{h} heads do not split over sp {mesh.size}")
    hs = h // mesh.size
    recv = mesh.all_to_all([x[:, :, j * hs:(j + 1) * hs] for j in range(mesh.size)])
    return unshard_frames(recv, frames)


def heads_to_tokens(mesh: SPMesh, x: torch.Tensor, frames: int) -> torch.Tensor:
    """The inverse of `tokens_to_heads`: [B, n, H/sp, ...] -> this rank's
    frame shard [B, n/sp, H, ...] of every head."""
    parts = x.unflatten(1, (frames, mesh.size, x.shape[1] // (frames * mesh.size)))
    recv = mesh.all_to_all([parts[:, :, j].flatten(1, 2) for j in range(mesh.size)])
    return torch.cat(recv, dim=2)


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """Which slice of which cache axis a rank holds: axis "heads" or
    "slots", [lo, hi); "none" for the whole cache."""

    axis: str
    lo: int
    hi: int


def wan_kv_cache_shard(sp_mode: str, spec: KVCacheSpec, mesh: SPMesh) -> CacheShard:
    """The Wan cache's shard for an island (JAX `wan_kv_cache_pspec`):
    ulysses, heads over sp; the ring modes, slots over sp; no island, all."""
    if sp_mode == "none" or mesh.size == 1:
        return CacheShard("none", 0, 0)
    if sp_mode == "ulysses":
        axis, n = "heads", spec.num_kv_heads
    elif sp_mode in ("ring", "ring_pass_q", "ring_pass_kv"):
        axis, n = "slots", spec.slots
    else:
        raise ValueError(f"unknown sp attention mode {sp_mode!r}")
    if n % mesh.size:
        raise ValueError(f"{sp_mode}: {n} cache {axis} do not split over sp {mesh.size}")
    per = n // mesh.size
    return CacheShard(axis, mesh.rank * per, (mesh.rank + 1) * per)


def init_kv_cache_shard(spec: KVCacheSpec, shard: CacheShard,
                        device: str | torch.device = "cuda") -> KVCache:
    """This rank's buffers of the cache (`init_kv_cache` of its slice)."""
    n = shard.hi - shard.lo
    if shard.axis == "heads":
        return init_kv_cache(spec, device, num_kv_heads=n)
    if shard.axis == "slots":
        return init_kv_cache(spec, device, slots=n)
    return init_kv_cache(spec, device)
