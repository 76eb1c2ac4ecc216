"""Tiled (and device-parallel) VAE decode and encode over overlapping 3D
tiles (port of `inferix_tpu/parallel/tile_parallel.py`: `Tile`,
`split_tiles`, `_blend_axis`, `TileProcessor`).

A video or latent is split into overlapping spatial-temporal tiles, each
tile goes through the VAE on a device, the tiles are spread over the
devices big ones first, strided, and the overlaps are blended with linear
ramps on the host in numpy, as in the JAX package (the reference's
blend_t / v / h, `inferix/distributed/parallelism/tile_parallel.py:230-252`).
The devices are `torch.device`s; a tile is copied to its device and `fn`
runs there (`Replicas` keeps one copy of a model's parameters a device).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Tile:
    t0: int
    t1: int
    h0: int
    h1: int
    w0: int
    w1: int

    @property
    def numel(self) -> int:
        return (self.t1 - self.t0) * (self.h1 - self.h0) * (self.w1 - self.w0)


def split_tiles(t: int, h: int, w: int, tile_t: int, tile_h: int, tile_w: int,
                overlap_h: int, overlap_w: int, overlap_t: int = 0) -> List[Tile]:
    """The overlapping 3D tile grid (reference ParallelHelper.split_tile_list)."""
    def starts(total, tile, ov):
        if total <= tile:
            return [0]
        s = list(range(0, total - tile, tile - ov))
        s.append(total - tile)
        return s

    return [Tile(tt, min(tt + tile_t, t), hh, min(hh + tile_h, h), ww, min(ww + tile_w, w))
            for tt in starts(t, tile_t, overlap_t)
            for hh in starts(h, tile_h, overlap_h)
            for ww in starts(w, tile_w, overlap_w)]


def _blend_axis(out: np.ndarray, new: np.ndarray, axis: int, overlap: int) -> np.ndarray:
    """A linear ramp blend of `new` onto `out` along `axis` over `overlap`
    entries (new is written in place and returned)."""
    if overlap <= 0:
        return new
    ramp_shape = [1] * new.ndim
    ramp_shape[axis] = overlap
    ramp = np.linspace(0.0, 1.0, overlap + 2)[1:-1].reshape(ramp_shape)
    sl = [slice(None)] * new.ndim
    sl[axis] = slice(0, overlap)
    new[tuple(sl)] = out[tuple(sl)] * (1 - ramp) + new[tuple(sl)] * ramp
    return new


def canonical(device) -> torch.device:
    """device with its index ("cuda" is the current card, as a tensor's
    device names it)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _tree_to(tree: Any, device: torch.device) -> Any:
    """Every tensor of a tree of dicts, lists, tuples and named tuples (the
    halo convs' `PackedWeight`) on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Replicas:
    """One copy of a model a device: the model itself on its own device, a
    shallow copy with its `params` moved elsewhere. The copies are made at
    the first use of a device and made again when the model's `params`
    change identity, so that a decode never runs on stale weights and never
    copies the weights once a tile."""

    def __init__(self, model):
        self.model = model
        self._params = None
        self._copies: Dict[torch.device, Any] = {}

    def on(self, device) -> Any:
        device = canonical(device)
        if self.model.params is not self._params:
            self._params, self._copies = self.model.params, {}
        if device not in self._copies:
            if device == canonical(self.model.device):
                self._copies[device] = self.model
            else:
                rep = copy.copy(self.model)
                rep.params, rep.device = _tree_to(self.model.params, device), device
                self._copies[device] = rep
        return self._copies[device]


class TileProcessor:
    """Applies `fn` a tile with overlap blending; the tiles spread over
    `devices` (the reference's strided assignment of tiles sorted by size).

    fn maps a tile [B, t, h, w, C] on its device to [B, t scale_t,
    h scale_hw, w scale_hw, C'] (a VAE decode upsamples). devices: torch
    devices (default: the tile's own device)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], scale_t: int = 1,
                 scale_hw: int = 1, devices: Optional[Sequence] = None):
        self.fn = fn
        self.scale_t = scale_t
        self.scale_hw = scale_hw
        self.devices = [canonical(d) for d in devices] if devices else None

    def assignment(self, tiles: List[Tile], default: torch.device) -> List[torch.device]:
        """Each tile's device: big tiles first, strided over the devices."""
        devices = self.devices or [default]
        order = sorted(range(len(tiles)), key=lambda i: -tiles[i].numel)
        out: List[Optional[torch.device]] = [None] * len(tiles)
        for i, idx in enumerate(order):
            out[idx] = devices[i % len(devices)]
        return out

    def process(self, x: torch.Tensor, tile_t: int, tile_h: int, tile_w: int,
                overlap_h: int = 8, overlap_w: int = 8, overlap_t: int = 0) -> np.ndarray:
        """x [B, T, H, W, C] -> the blended output on the host."""
        b, t, h, w, _ = x.shape
        tiles = split_tiles(t, h, w, tile_t, tile_h, tile_w, overlap_h, overlap_w, overlap_t)
        where = self.assignment(tiles, x.device)
        # every tile is launched before any result is read back
        results = [self.fn(x[:, tl.t0:tl.t1, tl.h0:tl.h1, tl.w0:tl.w1].to(dev))
                   for tl, dev in zip(tiles, where)]
        st, sh = self.scale_t, self.scale_hw
        out: Optional[np.ndarray] = None
        for tl, res in zip(tiles, results):
            # a writable copy (the blend writes into it); bf16 as float32
            res = np.array(res.detach().to("cpu", torch.float32 if res.dtype == torch.bfloat16
                                            else res.dtype))
            if out is None:
                out = np.zeros((b, t * st, h * sh, w * sh, res.shape[-1]), res.dtype)
            sl = (slice(None), slice(tl.t0 * st, tl.t1 * st), slice(tl.h0 * sh, tl.h1 * sh),
                  slice(tl.w0 * sh, tl.w1 * sh))
            if tl.t0 > 0 and overlap_t:
                res = _blend_axis(out[sl], res, 1, overlap_t * st)
            if tl.h0 > 0 and overlap_h:
                res = _blend_axis(out[sl], res, 2, overlap_h * sh)
            if tl.w0 > 0 and overlap_w:
                res = _blend_axis(out[sl], res, 3, overlap_w * sh)
            out[sl] = res
        return out
