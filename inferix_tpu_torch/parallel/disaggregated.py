"""Disaggregated serving: the streaming block decode on decode devices of its
own (port of `inferix_tpu/parallel/disaggregated.py`: `_split_w`,
`PixelTiles`, `DisaggregatedVAEDecoder`).

On one card the TRUE_STREAMING loop decodes each block between two blocks'
denoise, so a block costs generation plus decode. With the decode on other
cards the decode of block i runs there while block i + 1 denoises here:
CUDA launches are asynchronous, nothing in the decode path waits for the
card, so the generator's next launches are not held back, and a block
then costs about the larger of the two.

The latent width splits into tiles with `overlap` latent columns of halo
on interior edges; tile i decodes on device i % len(devices) through that
device's copy of the Wan `CausalVAE` (`tile_parallel.Replicas`: made at the
first use, made again when the VAE's params change identity), and keeps
its temporal-conv cache there. `decode_chunk` returns `PixelTiles`, the
tiles' pixels still on their devices; `assemble` blends the seams on the
host (the reference's blend_h, `tile_parallel.py:230-252`) and is the only
point where anything leaves the decode devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tile_parallel import Replicas, canonical

Span = Tuple[int, int, int, int]


def _split_w(w: int, tiles: int, overlap: int) -> List[Span]:
    """Split the latent width into `tiles` slices with `overlap` halo
    columns on interior edges: (w0, w1, keep0, keep1), [w0:w1] the decoded
    slice and [keep0:keep1] (slice-relative) the owned region; the rest is
    blended seam."""
    assert tiles >= 1 and w >= tiles
    base = [w * i // tiles for i in range(tiles + 1)]
    out = []
    for i in range(tiles):
        lo, hi = base[i], base[i + 1]
        w0 = max(0, lo - (overlap if i > 0 else 0))
        w1 = min(w, hi + (overlap if i < tiles - 1 else 0))
        out.append((w0, w1, lo - w0, hi - w0))
    return out


@dataclasses.dataclass
class PixelTiles:
    """The tiles' pixels, each [B, T_px, H_px, w_px_i, 3] on its decode
    device, and the seam geometry (latent spans)."""

    tiles: List[torch.Tensor]
    spans: List[Span]
    scale: int = 8

    @property
    def shape(self) -> Tuple[int, ...]:
        """The assembled shape [B, T_px, H_px, W_px, C], so that callbacks
        that count frames take a PixelTiles as they take an array."""
        b, tpx, hpx, _, c = self.tiles[0].shape
        return (b, tpx, hpx, self.spans[-1][1] * self.scale, c)

    def synchronize(self) -> "PixelTiles":
        """Wait until every tile's decode has finished on its device."""
        for t in self.tiles:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
        return self

    def assemble(self) -> np.ndarray:
        """One host array, the interior seams blended with a linear ramp."""
        def host(t):
            return t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16
                                 else t.dtype).numpy()

        if len(self.tiles) == 1:
            return host(self.tiles[0])
        s = self.scale
        b, tpx, hpx, _, c = self.tiles[0].shape
        res0 = host(self.tiles[0])
        out = np.zeros((b, tpx, hpx, self.spans[-1][1] * s, c), res0.dtype)
        for i, (tile, (w0, _, k0, _)) in enumerate(zip(self.tiles, self.spans)):
            res = res0 if i == 0 else host(tile)
            ov = k0 * s   # the pixel overlap on the left edge
            if i > 0 and ov > 0:
                ramp = np.linspace(0.0, 1.0, ov + 2)[1:-1].reshape(1, 1, 1, ov, 1)
                left = w0 * s
                out[:, :, :, left:left + ov] = (out[:, :, :, left:left + ov] * (1 - ramp)
                                                + res[:, :, :, :ov] * ramp)
                out[:, :, :, left + ov:left + res.shape[3]] = res[:, :, :, ov:]
            else:
                out[:, :, :, w0 * s:w0 * s + res.shape[3]] = res
        return out


class TileCaches(list):
    """The per-tile temporal-conv caches of a tiled decode, with the spans
    that made them."""

    def __init__(self, caches: Sequence[Any], spans: Sequence[Span]):
        super().__init__(caches)
        self.spans = list(spans)


class DisaggregatedVAEDecoder:
    """Routes the streaming block decode to `devices`.

    vae: a Wan `CausalVAE`. tiles defaults to len(devices) (tile i on device
    i % len(devices)). overlap: the halo in latent columns on interior
    tile edges (the pixels blend over 8 times that). `decode_chunk(z,
    cache, first)` has the shape of `CausalVAE.decode_chunk`, so the
    TRUE_STREAMING block hook of `SelfForcingPipeline` takes it in place of
    the VAE; its pixels come back as `PixelTiles` in [0, 1] and its cache
    is the tiles' caches."""

    def __init__(self, vae, devices: Sequence, tiles: Optional[int] = None,
                 overlap: int = 2):
        self.vae = vae
        self.devices = [canonical(d) for d in devices]
        self.tiles = int(tiles) if tiles else len(self.devices)
        self.overlap = overlap
        assert self.tiles >= 1 and self.devices
        self._dev_for_tile = [self.devices[i % len(self.devices)] for i in range(self.tiles)]
        self._replicas = Replicas(vae)
        self.scale = vae.cfg.spatial_factor

    def decode_chunk(self, z: torch.Tensor, cache: Optional[TileCaches],
                     first: bool) -> Tuple[PixelTiles, TileCaches]:
        """z [B, T, h, w, zdim] (the generator's layout) -> the tiles' pixels
        in [0, 1] on their devices and their caches. A carried cache must
        come from a decode of the same span list (the same latent width):
        another raises ValueError."""
        spans = _split_w(z.shape[3], self.tiles, self.overlap)
        if cache is not None and getattr(cache, "spans", None) != spans:
            raise ValueError(f"the carried cache was made for the tile spans "
                             f"{getattr(cache, 'spans', None)}; this chunk's are {spans}")
        outs: List[torch.Tensor] = []
        caches = []
        for i, (w0, w1, _, _) in enumerate(spans):
            vae = self._replicas.on(self._dev_for_tile[i])
            out, ci = vae.decode_chunk(z[:, :, :, w0:w1], None if cache is None else cache[i],
                                       first=first)
            outs.append(torch.clamp(out, -1.0, 1.0) * 0.5 + 0.5)
            caches.append(ci)
        return PixelTiles(outs, spans, self.scale), TileCaches(caches, spans)
