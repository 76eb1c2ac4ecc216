"""Plain float32 reference of the Self-Forcing Wan2.1 block-causal DiT.

Written from the model's equations (Wan2.1's DiT with per-frame AdaLN, RMS
qk-norm over the whole width, 3-axis interleaved rope, text cross-attention
and a GELU-tanh FFN; Self-Forcing's few-step flow-matching denoise of each
3-frame block over a cache of the clean blocks before it). Plain torch in
float32, TF32 off, no kernels, no batching: one stream. It imports nothing
of the program under test.

Parameters are the benchmark's seeded tree (`benchmark/weights.py`, linear
weights [in, out], layers stacked on a leading axis), cast to float32 here.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Q_ROWS = 1170  # query rows a chunk of the self-attention (bounds the logits' bytes)


def fp32_tree(tree):
    if isinstance(tree, dict):
        return {k: fp32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp32_tree(v) for v in tree]
    return tree.float()


def strict_fp32() -> None:
    """Matrix products and convolutions in true float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(p, x):
    return x @ p["w"] + p["b"]


def layer(blocks, i):
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def ln(x, eps, w=None, b=None):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


class Schedule:
    """Flow matching over 1000 shifted sigmas (Wan / Self-Forcing): sigma(s)
    = shift s / (1 + (shift - 1) s) over linspace(1, 0, 1001)[:-1]; a
    timestep reads the sigma of the nearest table timestep. Denoising steps
    are warped through the table (timesteps[1000 - step], a trailing 0)."""

    def __init__(self, shift: float):
        s = np.linspace(1.0, 0.0, 1001, dtype=np.float64)[:-1]
        self.sigmas = shift * s / (1.0 + (shift - 1.0) * s)
        self.timesteps = self.sigmas * 1000.0

    def warp(self, steps: Sequence[int]) -> List[float]:
        ts = np.concatenate([self.timesteps, [0.0]])
        return [float(ts[1000 - s]) for s in steps]

    def sigma(self, t: float) -> float:
        return float(self.sigmas[int(np.argmin(np.abs(self.timesteps - t)))])


class WanReference:
    """m: the model section of the configuration (dict); params: the seeded
    tree (any dtype); device: where the float32 copy lives."""

    def __init__(self, m: Dict, params, device, frames_per_block: int,
                 latent_hw: Sequence[int], max_tokens: int):
        self.m = m
        self.dim, self.heads = m["dim"], m["num_heads"]
        self.hd = self.dim // self.heads
        self.eps = m.get("eps", 1e-6)
        self.patch = tuple(m.get("patch_size", (1, 2, 2)))
        self.p = fp32_tree(params)
        self.dev = device
        self.fpb = frames_per_block
        self.lh, self.lw = latent_hw
        self.gh, self.gw = self.lh // self.patch[1], self.lw // self.patch[2]
        self.frame_seq = self.gh * self.gw
        self.max_tokens = max_tokens
        c = self.hd // 2
        split = (c - 2 * (c // 3), c // 3, c // 3)
        self.inv = [1.0 / np.power(10000.0, np.arange(0, 2 * a, 2, dtype=np.float64) / (2 * a))
                    for a in split]
        L = m["num_layers"]
        self.k = [torch.zeros(max_tokens, self.heads, self.hd, device=device) for _ in range(L)]
        self.v = [torch.zeros(max_tokens, self.heads, self.hd, device=device) for _ in range(L)]

    # -- embeddings ---------------------------------------------------------

    def rope_cos_sin(self, start_frame: int):
        f, h, w = self.fpb, self.gh, self.gw
        pos = [np.arange(start_frame, start_frame + f), np.arange(h), np.arange(w)]
        ang = [np.outer(p, inv) for p, inv in zip(pos, self.inv)]
        grid = np.concatenate([
            np.broadcast_to(ang[0][:, None, None, :], (f, h, w, ang[0].shape[1])),
            np.broadcast_to(ang[1][None, :, None, :], (f, h, w, ang[1].shape[1])),
            np.broadcast_to(ang[2][None, None, :, :], (f, h, w, ang[2].shape[1]))], -1)
        grid = grid.reshape(f * h * w, -1)
        cos = torch.as_tensor(np.cos(grid), dtype=torch.float32, device=self.dev)
        sin = torch.as_tensor(np.sin(grid), dtype=torch.float32, device=self.dev)
        return cos[:, None, :], sin[:, None, :]

    @staticmethod
    def rope(x, cos, sin):
        """Rotate the (even, odd) pairs of the head dim: x [S, H, D]."""
        xe, xo = x[..., 0::2], x[..., 1::2]
        return torch.stack([xe * cos - xo * sin, xo * cos + xe * sin], -1).flatten(-2)

    def time_embed(self, t: float):
        half = self.m.get("freq_dim", 256) // 2
        freqs = torch.pow(torch.tensor(10000.0, device=self.dev),
                          -torch.arange(half, dtype=torch.float32, device=self.dev) / half)
        arg = torch.full((self.fpb,), t, device=self.dev)[:, None] * freqs
        emb = torch.cat([torch.cos(arg), torch.sin(arg)], -1)
        te = self.p["time_embedding"]
        e = linear(te["fc2"], F.silu(linear(te["fc1"], emb)))
        e0 = linear(self.p["time_projection"], F.silu(e)).reshape(self.fpb, 6, self.dim)
        return e, e0

    def text(self, context):
        """context [text_len, text_dim] -> per layer (K, V) [text_len, H, D]."""
        te = self.p["text_embedding"]
        ctx = linear(te["fc2"], F.gelu(linear(te["fc1"], context.float()), approximate="tanh"))
        out = []
        for i in range(self.m["num_layers"]):
            ca = layer(self.p["blocks"]["cross_attn"], i)
            k = rms(linear(ca["k"], ctx), ca["norm_k"]["w"], self.eps)
            v = linear(ca["v"], ctx)
            out.append((k.reshape(-1, self.heads, self.hd), v.reshape(-1, self.heads, self.hd)))
        return out

    def patchify(self, x):
        f, h, w, c = x.shape
        pt, ph, pw = self.patch
        x = x.reshape(f // pt, pt, h // ph, ph, w // pw, pw, c).permute(0, 2, 4, 1, 3, 5, 6)
        return x.reshape(-1, pt * ph * pw * c)

    def unpatchify(self, tok):
        pt, ph, pw = self.patch
        out = self.m.get("out_dim", 16)
        x = tok.reshape(self.fpb // pt, self.gh, self.gw, pt, ph, pw, out)
        return x.permute(0, 3, 1, 4, 2, 5, 6).reshape(self.fpb, self.lh, self.lw, out)

    # -- attention ----------------------------------------------------------

    def attend(self, q, k, v):
        """q [S, H, D] over every key of k, v [N, H, D], softmax in float32."""
        scale = self.hd ** -0.5
        kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)
        outs = []
        for r in range(0, q.shape[0], Q_ROWS):
            qc = q[r:r + Q_ROWS].permute(1, 0, 2)
            probs = torch.softmax((qc @ kt) * scale, dim=-1)
            outs.append((probs @ vt).permute(1, 0, 2))
        return torch.cat(outs)

    # -- forward ------------------------------------------------------------

    def forward(self, x, t: float, text_kv, start_frame: int, need_output: bool = True):
        """One forward over a block x [fpb, H, W, C] at timestep t; writes
        the block's K/V into the cache slots of its positions in every
        layer, attends over the cache's prefix up to the block's end.
        Returns the flow [fpb, H, W, out] (None without need_output)."""
        f = self.fpb
        start = start_frame * self.frame_seq
        s = f * self.frame_seq
        end = start + s
        if end > self.max_tokens:
            raise ValueError(f"block end {end} past the cache's {self.max_tokens} tokens")
        h = linear(self.p["patch_embedding"], self.patchify(x.float()))
        e, e0 = self.time_embed(t)
        cos, sin = self.rope_cos_sin(start_frame)
        per_frame = self.frame_seq

        def frames(v):  # [F, C] -> [S, C], each frame's row over its tokens
            return v.repeat_interleave(per_frame, dim=0)

        for i in range(self.m["num_layers"]):
            blk = layer(self.p["blocks"], i)
            mod = blk["modulation"][None] + e0
            sh_a, sc_a, g_a, sh_f, sc_f, g_f = (frames(mod[:, j]) for j in range(6))
            sa = blk["self_attn"]
            a_in = ln(h, self.eps) * (1.0 + sc_a) + sh_a
            q = rms(linear(sa["q"], a_in), sa["norm_q"]["w"], self.eps)
            k = rms(linear(sa["k"], a_in), sa["norm_k"]["w"], self.eps)
            v = linear(sa["v"], a_in).reshape(s, self.heads, self.hd)
            q = self.rope(q.reshape(s, self.heads, self.hd), cos, sin)
            k = self.rope(k.reshape(s, self.heads, self.hd), cos, sin)
            self.k[i][start:end] = k
            self.v[i][start:end] = v
            att = self.attend(q, self.k[i][:end], self.v[i][:end]).reshape(s, self.dim)
            h = h + linear(sa["o"], att) * g_a
            ca = blk["cross_attn"]
            cq = linear(ca["q"], ln(h, self.eps, blk["norm3"]["w"], blk["norm3"]["b"]))
            cq = rms(cq, ca["norm_q"]["w"], self.eps).reshape(s, self.heads, self.hd)
            xk, xv = text_kv[i]
            h = h + linear(ca["o"], self.attend(cq, xk, xv).reshape(s, self.dim))
            ffn = blk["ffn"]
            f_in = ln(h, self.eps) * (1.0 + sc_f) + sh_f
            y = linear(ffn["fc2"], F.gelu(linear(ffn["fc1"], f_in), approximate="tanh"))
            h = h + y * g_f
        if not need_output:
            return None
        hm = self.p["head"]["modulation"][None] + e[:, None, :]
        h = ln(h, self.eps) * (1.0 + frames(hm[:, 1])) + frames(hm[:, 0])
        return self.unpatchify(linear(self.p["head"]["head"], h))
