"""MAGI prefix-media preprocessing: image / video -> model-resolution
frames -> prefix latents for T2V / I2V / V2V (port of
`inferix_tpu/pipeline/magi_media.py`).

The geometry transforms run once on the host in numpy; file decoding goes
through imageio when it is installed. Semantics, as in the JAX package:

* aspect_policy "crop": scale so the short side covers, center-crop
  (ffmpeg `scale force_original_aspect_ratio=increase` + `crop`);
* aspect_policy "pad": scale so the long side fits, center-pad black
  (`scale force_original_aspect_ratio=decrease` + `pad`);
* aspect_policy "fit": anisotropic scale to exactly (h, w);
* the v2v tail clip keeps the LAST min(n // fps * fps, max_chunks * fps)
  frames, or the first `prefix_frame` frames when given.

The resize is `jax.image.resize(..., "bilinear")`'s: a triangle kernel at
half-pixel centres that widens by the scale on a downscale (antialiasing),
weights normalised over the input's pixels, one weight matrix an axis
(`_resize_weights`, computed in float32 as XLA computes JAX's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

Array = np.ndarray


def _resize_weights(in_size: int, out_size: int) -> Array:
    """[in_size, out_size] float32 weights of JAX's linear
    `scale_and_translate` with antialias (translation 0)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))   # in float64, then rounded, as JAX
    kernel_scale = max(inv_scale, np.float32(1.0))
    # (i + 0.5) * inv_scale - 0.5 with one rounding, as XLA contracts it
    # into a fused multiply-add: near 1280 a float32 ulp is 1.2e-4 of a
    # pixel, which a second rounding would move the weights by
    base = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)).astype(np.float64)
    sample = (base * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize(frames: Array, h: int, w: int) -> Array:
    """Bilinear (antialiased) resize [T, H0, W0, C] float32 -> [T, h, w, C]."""
    out = np.asarray(frames, np.float32)
    for axis, size in ((1, h), (2, w)):
        if out.shape[axis] != size:
            wm = _resize_weights(out.shape[axis], size)
            out = np.moveaxis(np.tensordot(out, wm, axes=([axis], [0])), -1, axis)
    return np.ascontiguousarray(out, np.float32)


def prepare_frames(frames: Array, h: int, w: int,
                   aspect_policy: str = "fit") -> Array:
    """uint8 / float [T, H0, W0, 3] -> float32 [T, h, w, 3] in [-1, 1]."""
    if frames.ndim == 3:
        frames = frames[None]
    f = frames.astype(np.float32)
    if frames.dtype == np.uint8:
        f = f / 127.5 - 1.0
    t, h0, w0, _ = f.shape
    if aspect_policy == "crop":
        s = max(h / h0, w / w0)
        hs, ws = max(h, int(round(h0 * s))), max(w, int(round(w0 * s)))
        f = _resize(f, hs, ws)
        y0, x0 = (hs - h) // 2, (ws - w) // 2
        f = f[:, y0:y0 + h, x0:x0 + w]
    elif aspect_policy == "pad":
        s = min(h / h0, w / w0)
        hs, ws = min(h, int(round(h0 * s))), min(w, int(round(w0 * s)))
        f = _resize(f, hs, ws)
        out = np.full((t, h, w, 3), -1.0, np.float32)  # black in [-1, 1]
        y0, x0 = (h - hs) // 2, (w - ws) // 2
        out[:, y0:y0 + hs, x0:x0 + ws] = f
        f = out
    else:  # "fit" (and the reference's unknown-policy fallback)
        f = _resize(f, h, w)
    return f


def clip_prefix_video(frames: Array, fps: int,
                      prefix_frame: Optional[int] = None,
                      max_chunks: int = 5) -> Array:
    """The reference ffmpeg_v2v frame-count policy (video_process.py:247-257)."""
    if prefix_frame is not None:
        return frames[:prefix_frame]
    n = frames.shape[0]
    if n < fps:
        clip_len = 1
    else:
        clip_len = min(n // fps * fps, max_chunks * fps)
    return frames[-clip_len:]


def process_image(image: Array, h: int, w: int,
                  aspect_policy: str = "fit") -> Array:
    """A single image [H0, W0, 3] -> [1, h, w, 3] prefix frames (ffmpeg_i2v)."""
    return prepare_frames(image[None] if image.ndim == 3 else image,
                          h, w, aspect_policy)[:1]


def process_prefix_video(frames: Array, fps: int, h: int, w: int,
                         prefix_frame: Optional[int] = None,
                         max_chunks: int = 5,
                         aspect_policy: str = "fit") -> Array:
    """Video frames [T, H0, W0, 3] -> clipped and resized prefix frames."""
    frames = clip_prefix_video(frames, fps, prefix_frame, max_chunks)
    return prepare_frames(frames, h, w, aspect_policy)


def load_media(path: str) -> Array:
    """Decode an image or video file to [T, H, W, 3] uint8 (imageio)."""
    try:
        import imageio
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            "imageio is required to decode media files; pass decoded numpy "
            "frames to process_image/process_prefix_video instead") from e
    if path.lower().endswith((".png", ".jpg", ".jpeg", ".webp", ".bmp")):
        return np.asarray(imageio.imread(path))[None, ..., :3]
    reader = imageio.get_reader(path)
    return np.stack([np.asarray(fr)[..., :3] for fr in reader])


def encode_prefix_latents(vae, frames: Array,
                          chunk_width: Optional[int] = None) -> torch.Tensor:
    """Prefix frames [T, h, w, 3] in [-1, 1] -> latents [1, F0, H', W', z]
    on the VAE's device through `vae.encode` (the mode). T is padded up to
    whole latent frames, and to whole chunks of chunk_width latent frames
    when given, by repeating the last frame (the MAGI walk consumes whole
    chunks; the reference floors, dropping frames)."""
    t = frames.shape[0]
    pl = vae.cfg.patch_length
    lat_t = -(-t // pl)
    if chunk_width is not None:
        lat_t = -(-lat_t // chunk_width) * chunk_width
    need = lat_t * pl
    if need > t:
        frames = np.concatenate([frames, np.repeat(frames[-1:], need - t, axis=0)])
    video = torch.as_tensor(np.asarray(frames, np.float32), device=vae.device)[None]
    return vae.encode(video)
