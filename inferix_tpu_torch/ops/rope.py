"""3D rotary position embeddings (port of `inferix_tpu/ops/rope.py`).

Angle tables are built in float64 on the host and applied in float32. The
head dim splits across (t, h, w): with c = head_dim // 2 the temporal axis
gets `c - 2*(c//3)` frequency pairs and each spatial axis `c//3`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


class RopeTables(NamedTuple):
    """Per-axis rotation angle tables, [max_pos, c_axis] float32."""

    t: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor


def rope_axis_split(head_dim: int) -> Tuple[int, int, int]:
    c = head_dim // 2
    return c - 2 * (c // 3), c // 3, c // 3


def build_rope_tables(head_dim: int, max_pos: int = 1024,
                      theta: float = 10000.0,
                      device: str | torch.device = "cuda") -> RopeTables:
    """Angle tables theta_j(p) = p * theta^(-2j/d_axis)."""
    assert head_dim % 2 == 0
    device = resolve_device(device)

    def table(c_axis: int) -> torch.Tensor:
        dim = 2 * c_axis
        inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
        ang = np.outer(np.arange(max_pos, dtype=np.float64), inv)
        return torch.as_tensor(ang, dtype=torch.float32, device=device)

    return RopeTables(*(table(c) for c in rope_axis_split(head_dim)))


def rope_angles(tables: RopeTables, f: int, h: int, w: int,
                start_frame=0) -> torch.Tensor:
    """Per-token angles for an (f, h, w) latent grid whose first frame sits
    at absolute frame `start_frame`: an int gives [f*h*w, head_dim//2]
    float32; a [B] tensor (one start a stream, continuous batching) gives
    [B, f*h*w, head_dim//2]."""
    if isinstance(start_frame, torch.Tensor) and start_frame.dim() == 1:
        frames = (start_frame.to(tables.t.device, torch.long)[:, None]
                  + torch.arange(f, device=tables.t.device))
        return torch.stack([rope_angles(tables._replace(t=tables.t[row]), f, h, w)
                            for row in frames])
    start_frame = int(start_frame)
    ang_t = tables.t[start_frame:start_frame + f]
    ang_h, ang_w = tables.h[:h], tables.w[:w]
    out = torch.cat([
        ang_t[:, None, None, :].expand(f, h, w, -1),
        ang_h[None, :, None, :].expand(f, h, w, -1),
        ang_w[None, None, :, :].expand(f, h, w, -1),
    ], dim=-1)
    return out.reshape(f * h * w, -1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved (even, odd) pairs of the head dim.

    x: [..., S, H, D]; angles: [S, D//2], or [B, S, D//2] for x [B, S, H, D]
    (one start a stream). Computed in float32 as
    x*cos + rot(x)*sin with rot(x)[2j] = -x[2j+1], rot(x)[2j+1] = x[2j]: term
    for term the arithmetic of the JAX default (the +-1 rotation matmul,
    `set_rope_impl("mxu")`, whose products by +-1 are exact). Cast back to
    x.dtype.
    """
    xf = x.float()
    cos = torch.cos(angles).repeat_interleave(2, dim=-1)[..., :, None, :]
    sin = torch.sin(angles).repeat_interleave(2, dim=-1)[..., :, None, :]
    xr = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).flatten(-2)
    return (xf * cos + xr * sin).to(x.dtype)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """Timestep embedding, [cos | sin] layout. float32 [..., dim]."""
    assert dim % 2 == 0
    half = dim // 2
    freqs = torch.pow(
        torch.tensor(10000.0, device=position.device),
        -torch.arange(half, dtype=torch.float32, device=position.device) / half)
    sinusoid = position.float()[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
