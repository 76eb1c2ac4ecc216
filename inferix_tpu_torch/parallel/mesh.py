"""The port's mesh: one process a rank over `torch.distributed` (port of
`inferix_tpu/parallel/mesh.py`: the rank grid, `param_pspecs`,
`wan_kv_cache_pspec`, `xattn_cache_pspec`, `magi_param_pspecs` and
`magi_kv_cache_pspec`).

The JAX package lays one `jax.sharding.Mesh` over its devices and lets GSPMD
place every tensor. The port runs one process a rank. `make_mesh` lays the
ranks on the JAX grid, `reshape(dp, sp, tp, pp)`, pp the fastest axis:
global rank = ((d sp + s) tp + t) pp + p (at pp 1, (d sp + s) tp + t). A
rank's `Mesh` holds a view (`SPMesh`) of each process group it is in, all
within its pipeline stage p: its sp group (the ranks of its (d, t)), its tp
group (of its (d, s)), its dp group (of its (s, t)) and its head group, the
combined (tp, sp) axis with tp the major one, as a JAX `PartitionSpec`
orders `("tp", "sp")`: rank (t, s) holds head slice t sp + s of tp sp; and
its pp group, the stages of its (d, s, t), which hand activations from
stage to stage (`SPMesh.send` / `recv`, `parallel/pipeline_parallel.py`).
A group of one makes no exchange.
The caller names the backend: "nccl" (one rank a card) or "gloo" (the CPU
tests, and several ranks on one card). gloo exchanges host tensors only, so
with gloo and CUDA tensors every exchange goes through host copies in
page-locked buffers (`host_staging`, counted in `staged_bytes`); each
group counts the bytes it sends and stages.

Placement, stated once (the JAX package leaves it to GSPMD):
- outside attention each rank holds the block's tokens `frame_shard`
  gives it: in every frame (a MAGI chunk), the rank's contiguous 1/sp of
  its tokens (the JAX `latent_pspec`, spatial rows over sp), replicated
  over tp. Linears, norms, modulation, cross-attention and the FFN run on
  those tokens only; the output head's tokens are gathered back
  (`gather_frame_shards`), so every rank ends a forward with the whole
  flow;
- parameters: `wan_param_shards` / `magi_param_shards` (Megatron column /
  row slices over tp, everything else replicated);
- the KV cache: `wan_kv_cache_shard` / `magi_kv_cache_shard` (heads over
  tp, and over sp too or slots over sp, by island);
- the text (and i2v image) K/V: heads over tp; latents and noise:
  replicated over sp and tp, batch rows over dp;
- under pp, the stacked layers of the tree, the text K/V and the cache:
  stage p holds layers [p L/pp, (p+1) L/pp) only
  (`pipeline_parallel.stage_layers`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.config import ParallelConfig
from ..core.device import resolve_device
from ..kvcache.cache import KVCache, KVCacheSpec, init_kv_cache

BACKENDS = ("nccl", "gloo")
FP8 = torch.float8_e4m3fn
REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as the backends take it: contiguous, e4m3 as its bytes."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class SPMesh:
    """A rank's view of one process group (the sequence-parallel one, or
    tp, dp, heads): its logical rank and the group's size. size 1 (`group`
    None) is one device: every collective is the identity and sends
    nothing. `members` lists the group's global ranks in logical order when
    it differs from the group's own (sorted) order, as the head group's
    tp-major order does."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    sent_bytes: int = 0     # bytes this rank put on the wire
    staged_bytes: int = 0   # bytes copied card -> host -> card around gloo
    members: Optional[Tuple[int, ...]] = None
    name: str = "sp"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of {self.size}")
        self.device = resolve_device(self.device)
        # logical index of the chunk at each group rank (the sorted members)
        self._order = (list(range(self.size)) if self.members is None else
                       [list(self.members).index(g) for g in sorted(self.members)])

    @property
    def host_staging(self) -> bool:
        """gloo with CUDA tensors: every exchange goes through host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        if self.host_staging:
            self.staged_bytes += _nbytes(t)
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            return buf
        return t

    def _back(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        t = t.view(dtype) if dtype == FP8 else t
        if self.host_staging:
            self.staged_bytes += _nbytes(t)
            return t.to(self.device, non_blocking=True)
        return t

    def _empty_like(self, shape, dtype) -> torch.Tensor:
        dev = "cpu" if self.host_staging else self.device
        return torch.empty(shape, dtype=torch.uint8 if dtype == FP8 else dtype, device=dev,
                           pin_memory=self.host_staging)

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """chunks[j] goes to rank j; returns what each rank sent here, in rank
        order (every chunk of one shape and dtype). One `all_to_all_single`
        over the chunks stacked: gloo has no list all-to-all."""
        if self.size == 1:
            return list(chunks)
        dtype = chunks[0].dtype
        send = self._out(_wire(torch.stack([chunks[j] for j in self._order])))
        recv = self._empty_like(send.shape, dtype)
        self.sent_bytes += _nbytes(send) // self.size * (self.size - 1)
        dist.all_to_all_single(recv, send, group=self.group)
        got = self._back(recv, dtype).unbind(0)
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for gr, j in enumerate(self._order):
            out[j] = got[gr]
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's t, in rank order."""
        if self.size == 1:
            return [t]
        send = self._out(_wire(t))
        recv = [self._empty_like(t.shape, t.dtype) for _ in range(self.size)]
        self.sent_bytes += _nbytes(send) * (self.size - 1)
        dist.all_gather(recv, send, group=self.group)
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for gr, j in enumerate(self._order):
            out[j] = self._back(recv[gr], t.dtype)
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum ("sum") or maximum ("max") of every rank's t,
        in t's dtype, as a new tensor (t is left as it was), the same on
        every rank. The ring all-reduce sends each element 2 (size - 1) /
        size times."""
        if self.size == 1:
            return t
        if t.dtype == FP8:
            raise TypeError("all_reduce takes no e4m3 tensor")
        buf = self._out(t.contiguous())
        buf = buf.clone() if buf.data_ptr() == t.data_ptr() else buf
        self.sent_bytes += 2 * _nbytes(buf) * (self.size - 1) // self.size
        dist.all_reduce(buf, op=REDUCE_OPS[op], group=self.group)
        return self._back(buf, t.dtype)

    def ring_shift(self, tensors: Sequence[torch.Tensor],
                   recv_shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
        """Send each tensor to rank + 1 and receive recv_shapes[i] (same
        dtype) from rank - 1, around the ring. A tensor (or shape) with no
        element is not exchanged: both sides know its size."""
        if self.size == 1:
            return list(tensors)
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

    def send(self, tensors: Sequence[torch.Tensor], dst: int) -> None:
        """Send each tensor to group rank dst, in order (a blocking
        point-to-point send; the receiver knows the shapes and dtypes)."""
        for t in tensors:
            s = self._out(_wire(t))
            self.sent_bytes += _nbytes(s)
            dist.send(s, self._global(dst), group=self.group)

    def recv(self, like: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
             src: int) -> List[torch.Tensor]:
        """Receive one tensor of each (shape, dtype) of `like` from group rank
        src, in the order it sent them."""
        out = []
        for shape, dtype in like:
            buf = self._empty_like(shape, dtype)
            dist.recv(buf, self._global(src), group=self.group)
            out.append(self._back(buf, dtype))
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Group rank src's t on every rank. Elsewhere t only gives the shape
        and dtype (a "meta" tensor will do)."""
        if self.size == 1:
            return t
        if self.rank == src:
            buf = self._out(_wire(t))
            self.sent_bytes += _nbytes(buf) * (self.size - 1)
        else:
            buf = self._empty_like(t.shape, t.dtype)
        dist.broadcast(buf, self._global(src), group=self.group)
        return t if self.rank == src else self._back(buf, t.dtype)

    def _global(self, rank: int) -> int:
        if self.members is not None:
            return self.members[rank]
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def _one(name: str, backend: str, device) -> SPMesh:
    return SPMesh(rank=0, size=1, backend=backend, device=device, name=name)


@dataclasses.dataclass
class Mesh:
    """A rank's place on the (dp, sp, tp, pp) grid and its view of each
    group (pp None: a group of one)."""

    cfg: ParallelConfig
    rank: int                 # global rank, ((d sp + s) tp + t) pp + p
    backend: str
    device: torch.device
    sp: SPMesh
    tp: SPMesh
    dp: SPMesh
    heads: SPMesh             # the combined (tp, sp) axis, tp major
    pp: Optional[SPMesh] = None   # the stages of the rank's (d, s, t)

    def __post_init__(self):
        if self.pp is None:
            self.pp = _one("pp", self.backend, self.device)

    @property
    def stage(self) -> int:
        """The rank's pipeline stage p."""
        return self.pp.rank

    def groups(self) -> Dict[str, SPMesh]:
        """The distinct groups of the rank, by name."""
        out: Dict[str, SPMesh] = {}
        for g in (self.sp, self.tp, self.dp, self.heads, self.pp):
            if all(g is not h for h in out.values()):
                out[g.name] = g
        return out

    @property
    def sent_bytes(self) -> int:
        return sum(g.sent_bytes for g in self.groups().values())

    @property
    def staged_bytes(self) -> int:
        return sum(g.staged_bytes for g in self.groups().values())

    def bytes_by_group(self) -> Dict[str, Tuple[int, int]]:
        """(sent, staged) bytes of each group of more than one rank."""
        return {n: (g.sent_bytes, g.staged_bytes) for n, g in self.groups().items()
                if g.size > 1}

    def reset_bytes(self) -> None:
        for g in self.groups().values():
            g.sent_bytes = g.staged_bytes = 0


def as_mesh(mesh) -> Optional[Mesh]:
    """A `Mesh`, or None. An `SPMesh` alone is a mesh of sp ranks only (its
    tp and dp groups of one)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if not isinstance(mesh, SPMesh):
        raise TypeError(f"a mesh must be a Mesh or an SPMesh, got {type(mesh).__name__}")
    return Mesh(cfg=ParallelConfig(sp=mesh.size), rank=mesh.rank, backend=mesh.backend, device=mesh.device,
                sp=mesh, tp=_one("tp", mesh.backend, mesh.device),
                dp=_one("dp", mesh.backend, mesh.device), heads=mesh)


def grid_place(cfg: ParallelConfig, rank: int) -> Tuple[int, int, int, int]:
    """(d, s, t, p) of a global rank on the JAX grid reshape(dp, sp, tp, pp)."""
    p, rest = rank % cfg.pp, rank // cfg.pp
    return rest // (cfg.sp * cfg.tp), rest // cfg.tp % cfg.sp, rest % cfg.tp, p


def grid_coords(cfg: ParallelConfig, rank: int) -> Tuple[int, int, int]:
    """(d, s, t) of a global rank (its stage left out)."""
    return grid_place(cfg, rank)[:3]


def _grid_rank(cfg: ParallelConfig, d: int, s: int, t: int, p: int = 0) -> int:
    return ((d * cfg.sp + s) * cfg.tp + t) * cfg.pp + p


def _layout_groups(cfg: ParallelConfig) -> List[Tuple[str, List[List[int]]]]:
    """Every group of the layout, in the order each rank builds them: for
    each axis, its groups' global ranks in logical order; the sp, tp, dp
    and head groups once a stage, then the pp groups. At pp 1 these are the
    groups of the (dp, sp, tp) grid."""
    dp, sp, tp, pp = cfg.dp, cfg.sp, cfg.tp, cfg.pp
    out = []
    for p in range(pp):
        r = lambda d, s, t: _grid_rank(cfg, d, s, t, p)  # noqa: E731
        out += [
            ("sp", [[r(d, s, t) for s in range(sp)] for d in range(dp) for t in range(tp)]),
            ("tp", [[r(d, s, t) for t in range(tp)] for d in range(dp) for s in range(sp)]),
            ("dp", [[r(d, s, t) for d in range(dp)] for s in range(sp) for t in range(tp)]),
            ("heads", [[r(d, s, t) for t in range(tp) for s in range(sp)] for d in range(dp)]),
        ]
    out.append(("pp", [[_grid_rank(cfg, d, s, t, p) for p in range(pp)]
                       for d in range(dp) for s in range(sp) for t in range(tp)]))
    return out


def make_mesh(cfg: ParallelConfig, rank: int, backend: str,
              device: str | torch.device = "cuda",
              init_method: Optional[str] = None) -> Optional[Mesh]:
    """This rank's mesh for `cfg`. Initialises the default process group
    with `backend` from `init_method` ("file://...", "tcp://host:port")
    when it is not initialised yet, with a world of dp sp tp pp. An
    initialised world may be larger: the layout takes its first dp sp tp pp
    ranks, and the others get None. Every rank of the world must call this
    with the same cfg (each creates every group of the layout, in one
    order, as `dist.new_group` requires)."""
    world = cfg.world_size
    if not dist.is_initialized():
        if world == 1:
            return single_device_mesh(device, backend)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    everyone = dist.get_world_size()
    if everyone < world or dist.get_rank() != rank:
        raise ValueError(f"the process group has rank {dist.get_rank()} of "
                         f"{everyone}, the mesh wants {rank} of {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()!r}, "
                         f"the mesh names {backend!r}")
    views: Dict[str, SPMesh] = {}
    for name, groups in _layout_groups(cfg):
        if name == "heads" and (cfg.tp == 1 or cfg.sp == 1):
            continue  # the sp or the tp group itself
        for members in groups:
            if len(members) == 1:
                if rank in members:
                    views[name] = _one(name, backend, device)
                continue
            # the world's group when the members are every rank; else a new
            # group, which every rank creates (members or not)
            group = None if len(members) == everyone else dist.new_group(sorted(members))
            if rank in members:
                views[name] = SPMesh(
                    rank=members.index(rank), size=len(members), backend=backend,
                    device=device, group=group, name=name,
                    members=None if members == sorted(members) else tuple(members))
    if rank >= world:
        return None
    if world == 1:
        return single_device_mesh(device, backend)
    if cfg.tp == 1:
        views["heads"] = views["sp"]
    elif cfg.sp == 1:
        views["heads"] = views["tp"]
    return Mesh(cfg=cfg, rank=rank, backend=backend, device=views["sp"].device,
                sp=views["sp"], tp=views["tp"], dp=views["dp"], heads=views["heads"],
                pp=views["pp"])


def single_device_mesh(device: str | torch.device = "cuda", backend: str = "nccl") -> Mesh:
    return as_mesh(_one("sp", backend, device))


# ---------------------------------------------------------------------------
# Where each rank's tokens and cache slice lie
# ---------------------------------------------------------------------------

def frame_shard(mesh: SPMesh, x: torch.Tensor, frames: int, dim: int = 1) -> torch.Tensor:
    """This rank's tokens of x (tokens frame-major on `dim`): in every one of
    the `frames` frames, the rank's contiguous 1/size of the frame's tokens.
    frames=1 gives a contiguous 1/size of the whole sequence."""
    if mesh.size == 1:
        return x
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
    if mesh.size == 1:
        return x
    return unshard_frames(mesh.all_gather(x), frames, dim)


def tokens_to_heads(mesh: SPMesh, x: torch.Tensor, frames: int) -> torch.Tensor:
    """[B, n/sp, H, ...] frame shards -> [B, n, H/sp, ...]: every token of
    the rank's contiguous 1/sp of the heads (one all-to-all; none at sp 1)."""
    h = x.shape[2]
    if h % mesh.size:
        raise ValueError(f"{h} heads do not split over sp {mesh.size}")
    if mesh.size == 1:
        return x
    hs = h // mesh.size
    recv = mesh.all_to_all([x[:, :, j * hs:(j + 1) * hs] for j in range(mesh.size)])
    return unshard_frames(recv, frames)


def heads_to_tokens(mesh: SPMesh, x: torch.Tensor, frames: int) -> torch.Tensor:
    """The inverse of `tokens_to_heads`: [B, n, H/sp, ...] -> this rank's
    frame shard [B, n/sp, H, ...] of every head."""
    if mesh.size == 1:
        return x
    parts = x.unflatten(1, (frames, mesh.size, x.shape[1] // (frames * mesh.size)))
    recv = mesh.all_to_all([parts[:, :, j].flatten(1, 2) for j in range(mesh.size)])
    return torch.cat(recv, dim=2)


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """The slice of the cache a rank holds. axis "heads": heads [lo, hi)
    over every slot; "slots": slots [lo, hi), of heads [head_lo, head_hi)
    (head_hi 0: every head); "none": the whole cache."""

    axis: str
    lo: int
    hi: int
    head_lo: int = 0
    head_hi: int = 0


def _slice_of(n: int, parts: int, index: int, what: str) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{n} {what} do not split over {parts} ranks")
    per = n // parts
    return index * per, (index + 1) * per


def wan_kv_cache_shard(sp_mode: str, spec: KVCacheSpec, mesh) -> CacheShard:
    """The Wan cache's shard (JAX `wan_kv_cache_pspec`): ulysses, heads over
    the combined (tp, sp) axis; the ring modes, slots over sp and heads over
    tp; no island, heads over tp (the whole cache at tp 1)."""
    mesh = as_mesh(mesh)
    if mesh is None:
        return CacheShard("none", 0, 0)
    tp = mesh.tp
    if sp_mode == "ulysses" and mesh.heads.size > 1:
        return CacheShard("heads", *_slice_of(spec.num_kv_heads, mesh.heads.size,
                                              mesh.heads.rank, f"{sp_mode}: cache heads"))
    if sp_mode in ("ring", "ring_pass_q", "ring_pass_kv") and mesh.sp.size > 1:
        heads = (_slice_of(spec.num_kv_heads, tp.size, tp.rank, "cache heads")
                 if tp.size > 1 else (0, 0))
        return CacheShard("slots", *_slice_of(spec.slots, mesh.sp.size, mesh.sp.rank,
                                              f"{sp_mode}: cache slots"), *heads)
    if sp_mode not in ("none", "ulysses", "ring", "ring_pass_q", "ring_pass_kv"):
        raise ValueError(f"unknown sp attention mode {sp_mode!r}")
    if tp.size > 1:
        return CacheShard("heads", *_slice_of(spec.num_kv_heads, tp.size, tp.rank,
                                              "cache heads"))
    return CacheShard("none", 0, 0)


def magi_kv_cache_shard(spec: KVCacheSpec, mesh) -> CacheShard:
    """MAGI's window cache (JAX `magi_kv_cache_pspec`): kv heads over the
    combined (tp, sp) axis, every slot (a head-major cache moves the shard
    axis with its heads)."""
    mesh = as_mesh(mesh)
    if mesh is None or mesh.heads.size == 1:
        return CacheShard("none", 0, 0)
    return CacheShard("heads", *_slice_of(spec.num_kv_heads, mesh.heads.size,
                                          mesh.heads.rank, "kv heads"))


def init_kv_cache_shard(spec: KVCacheSpec, shard: CacheShard,
                        device: str | torch.device = "cuda") -> KVCache:
    """This rank's buffers of the cache (`init_kv_cache` of its slice)."""
    if shard.axis == "heads":
        return init_kv_cache(spec, device, num_kv_heads=shard.hi - shard.lo)
    if shard.axis == "slots":
        heads = shard.head_hi - shard.head_lo if shard.head_hi else None
        return init_kv_cache(spec, device, num_kv_heads=heads, slots=shard.hi - shard.lo)
    return init_kv_cache(spec, device)


# ---------------------------------------------------------------------------
# Parameter shards over tp (the JAX `param_pspecs` / `magi_param_pspecs`)
# ---------------------------------------------------------------------------

def _split(t: torch.Tensor, tp: SPMesh, dim: int) -> torch.Tensor:
    """The rank's contiguous 1/tp of axis `dim`, as a tensor of its own (the
    whole tree can then be freed)."""
    if t.shape[dim] % tp.size:
        raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split over tp "
                         f"{tp.size} on axis {dim}")
    part = t.tensor_split(tp.size, dim=dim)[tp.rank]
    if t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        # a K-contiguous weight (the quantized GEMMs' layout) stays so
        return part.transpose(-1, -2).contiguous().transpose(-1, -2)
    return part.contiguous() if not part.is_contiguous() else part.clone()


def _cols(t: torch.Tensor, tp: SPMesh) -> torch.Tensor:
    return _split(t, tp, -1)


def _rows(t: torch.Tensor, tp: SPMesh) -> torch.Tensor:
    return _split(t, tp, -2)


def column_shard(p: Dict[str, Any], tp: SPMesh) -> Dict[str, Any]:
    """A column-parallel linear: its weight's output axis and everything
    per output channel (bias, per-channel scales) sliced."""
    n = p["w_q"].shape[-1] if "w_q" in p else p["w"].shape[-1]
    out = {}
    for k, v in p.items():
        per_out = k in ("w", "w_q", "b") or (k in ("scale", "weight_scale")
                                             and v.dim() >= 1 and v.shape[-1] == n)
        out[k] = _cols(v, tp) if per_out and v.shape[-1] > 1 else v
    return out


def row_shard(p: Dict[str, Any], tp: SPMesh) -> Dict[str, Any]:
    """A row-parallel linear: its weight's input axis sliced; the bias and
    the per-output-channel scales kept whole; per-input-channel vectors
    (MAGI's fp8 act_scale / smooth_scale) sliced with the input."""
    k_in = (p["w_q"] if "w_q" in p else p["w"]).shape[-2]
    out = {}
    for k, v in p.items():
        if k in ("w", "w_q"):
            out[k] = _rows(v, tp)
        elif k in ("act_scale", "smooth_scale") and v.dim() >= 1 and v.shape[-1] == k_in:
            out[k] = _cols(v, tp)
        else:
            out[k] = v
    return out


WAN_COLUMN = (("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"),
              ("cross_attn", "q"), ("cross_attn", "k"), ("cross_attn", "v"), ("ffn", "fc1"))
WAN_ROW = (("self_attn", "o"), ("cross_attn", "o"), ("ffn", "fc2"))
# the full-width RMS norms over head-sharded columns: their weights sliced
# with the columns they scale
WAN_NORMS = (("self_attn", "norm_q"), ("self_attn", "norm_k"),
             ("cross_attn", "norm_q"), ("cross_attn", "norm_k"))


def wan_param_shards(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's causal-DiT tree (JAX `param_pspecs`): q/k/v (self and
    cross) and fc1 column-parallel, o (self and cross) and fc2
    row-parallel, the qk-norm weights sliced with their columns; the i2v
    k_img / v_img, everything else in the blocks and everything outside
    them replicated. The tree at tp 1 is returned as it is."""
    tp = as_mesh(mesh).tp if mesh is not None else None
    if tp is None or tp.size == 1:
        return params
    blocks = params["blocks"]
    if "qkv" in blocks["self_attn"]:
        raise ValueError("a fused qkv tree does not shard over tp: fuse_qkv stays off")
    new = {k: dict(v) if isinstance(v, dict) else v for k, v in blocks.items()}
    for mod, name in WAN_COLUMN:
        new[mod][name] = column_shard(blocks[mod][name], tp)
    for mod, name in WAN_ROW:
        new[mod][name] = row_shard(blocks[mod][name], tp)
    for mod, name in WAN_NORMS:
        new[mod][name] = {k: _cols(v, tp) for k, v in blocks[mod][name].items()}
    return {**params, "blocks": new}


MAGI_COLUMN = ("q", "qx", "k", "v", "kv_xattn", "fc1", "fc1_up")
MAGI_ROW = ("proj", "fc2")


def magi_param_shards(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's MAGI tree (JAX `magi_param_pspecs`): in every block
    container (stacked `blocks` / `blocks_mid`, the fp8 layout's
    `blocks_first` / `blocks_last`) q, qx, k, v, kv_xattn (its group-major
    [g, k|v, hd] output: whole kv groups), fc1 and fc1_up column-parallel
    with their per-out-channel `scale` / `weight_scale`, proj (its
    group-major input interleave: whole groups) and fc2 row-parallel;
    embedders, the final head and everything else replicated. A gated fc1
    shards in the gate / up separate layout (`split_gated_fc1` first), so
    each rank holds its [gate_t | up_t] columns."""
    tp = as_mesh(mesh).tp if mesh is not None else None
    if tp is None or tp.size == 1:
        return params
    out = dict(params)
    for key in ("blocks", "blocks_mid", "blocks_first", "blocks_last"):
        if key not in params:
            continue
        blk = dict(params[key])
        fc1 = blk["fc1"].get("w_q", blk["fc1"].get("w"))
        fc2 = blk["fc2"].get("w_q", blk["fc2"].get("w"))
        if "fc1_up" not in blk and fc1.shape[-1] == 2 * fc2.shape[-2]:
            raise ValueError("a gated [gate | up] fc1 does not shard over tp: "
                             "split_gated_fc1 first")
        for name in MAGI_COLUMN:
            if name in blk:
                blk[name] = column_shard(blk[name], tp)
        for name in MAGI_ROW:
            blk[name] = row_shard(blk[name], tp)
        out[key] = blk
    return out
