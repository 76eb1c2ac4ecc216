"""Work of the Self-Forcing Wan2.1 DiT and of its causal VAE decoder.

Shapes are one stream's (batch 1). The configuration's precision is bf16;
the time-embedding MLP and its projection are float32 in the model (Wan
keeps them so), and are counted at the float32 peak.
"""
from __future__ import annotations

from typing import Dict, List

from . import Work, attention, conv3d, linear


def _dims(m: Dict):
    d = m["dim"]
    return d, m["num_heads"], d // m["num_heads"], m["ffn_dim"], m["num_layers"]


def text_work(m: Dict) -> List[Work]:
    """A prompt's text embedding and every layer's cross-attention K and V
    over its `text_len` tokens (once a clip)."""
    d, _, _, _, L = _dims(m)
    s = m.get("text_len", 512)
    return [linear("linear", s, m.get("text_dim", 4096), d),
            linear("linear", s, d, d),
            linear("linear", s, d, d, calls=2 * L)]


def forward_work(m: Dict, q: int, keys: int, frames: int, need_output: bool = True,
                 patch_in: int = 64, patch_out: int = 64) -> List[Work]:
    """One DiT forward over a block of `q` tokens (`frames` latent frames)
    whose self-attention covers `keys` cache tokens (the block included)."""
    d, heads, hd, ffn, L = _dims(m)
    text = m.get("text_len", 512)
    freq = m.get("freq_dim", 256)
    work = [
        linear("linear", q, d, 3 * d, calls=L),          # q, k, v
        linear("linear", q, d, d, calls=3 * L),          # o, cross q, cross o
        linear("linear", q, d, ffn, calls=L),            # fc1
        linear("linear", q, ffn, d, calls=L),            # fc2
        linear("linear", q, patch_in, d),                # patch embedding
        linear("linear", frames, freq, d, precision="fp32", itemsize=4),
        linear("linear", frames, d, d, precision="fp32", itemsize=4),
        linear("linear", frames, d, 6 * d, precision="fp32", itemsize=4),
        attention("self_attention", q, keys, heads, hd, calls=L),
        attention("cross_attention", q, text, heads, hd, calls=L),
    ]
    if need_output:
        work.append(linear("linear", q, d, patch_out))   # head
    return work


def vae_decode_work(v: Dict, t: int, h: int, w: int, first: bool) -> List[Work]:
    """The decode of `t` latent frames [t, h, w, z] of a stream (its first
    chunk when `first`): every conv and the middle block's per-frame
    attention, at the shapes each runs."""
    dim, z = v["dim"], v["z_dim"]
    mult = tuple(v["dim_mult"])
    t_up = tuple(reversed(v["temperal_downsample"]))
    work: List[Work] = []

    def conv(tt, hh, ww, cin, cout, k):
        work.append(conv3d("vae_conv", tt, hh, ww, cin, cout, k))

    def res(tt, hh, ww, cin, cout):
        conv(tt, hh, ww, cin, cout, (3, 3, 3))
        conv(tt, hh, ww, cout, cout, (3, 3, 3))
        if cin != cout:
            conv(tt, hh, ww, cin, cout, (1, 1, 1))

    dims = [dim * u for u in (mult[-1], *reversed(mult))]
    conv(t, h, w, z, z, (1, 1, 1))
    conv(t, h, w, z, dims[0], (3, 3, 3))
    res(t, h, w, dims[0], dims[0])
    c = dims[0]
    conv(t, h, w, c, 3 * c, (1, 1, 1))
    work.append(attention("vae_attention", h * w, h * w, 1, c, calls=t))
    conv(t, h, w, c, c, (1, 1, 1))
    res(t, h, w, dims[0], dims[0])
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2
        for _ in range(v["num_res_blocks"] + 1):
            res(t, h, w, cin, cout)
            cin = cout
        if i == len(mult) - 1:
            continue
        if t_up[i] and not (first and t == 1):
            tt = t - 1 if first else t
            conv(tt, h, w, cout, 2 * cout, (3, 1, 1))
            t = 1 + 2 * tt if first else 2 * tt
        h, w = 2 * h, 2 * w
        conv(t, h, w, cout, cout // 2, (1, 3, 3))
    conv(t, h, w, dim, 3, (3, 3, 3))
    return work


def decoded_frames(t: int, first: bool) -> int:
    """Pixel frames the decode of t latent frames yields (4x temporal)."""
    return 4 * t - 3 if first else 4 * t
