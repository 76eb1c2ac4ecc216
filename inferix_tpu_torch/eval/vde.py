"""LV-Bench Video-Drift-Error (VDE) evaluation harness: the port's copy of
`inferix_tpu/eval/vde.py`.

The drift of each chunk's metric score from chunk 0, as a linear- or
log-weighted sum (LV-Bench `vde.py:17-46`), the metric factory
(`metrics.py:145-260`), and the quality delta between two videos that tracks
quantized against bf16 generation (BASELINE.md: <= 0.5 VBench delta). The
built-in metrics are host numpy, with float64 scores; `clarity` computes
OpenCV's gray conversion and Laplacian in numpy, bit-equal to `cv2`, so the
harness needs no OpenCV. The real VBench models plug into `BUILTIN_METRICS`
(`eval/vbench_real.py`, `eval/flow_metrics.py`); this registry is the port's
own, separate from the JAX package's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

MetricFn = Callable[[np.ndarray], float]  # chunk [T, H, W, 3] float [0,1] -> score


def vde(
    video_chunks: np.ndarray,  # [N, T, H, W, 3]
    metric_function: MetricFn,
    weight_type: str = "linear",
) -> float:
    """Weighted drift of each chunk's score from chunk 0 (reference vde())."""
    n = video_chunks.shape[0]
    if n < 2:
        return 0.0
    scores = np.asarray([metric_function(c) for c in video_chunks], np.float64)
    m1 = scores[0]
    if m1 == 0:
        return float("inf")
    drift = np.abs(scores[1:] - m1) / abs(m1)
    i = np.arange(2, n + 1, dtype=np.float64)
    if weight_type == "linear":
        weights = n - i + 1
    elif weight_type == "log":
        weights = np.log(n - i + 1)
    else:
        raise ValueError(f"unsupported weight type {weight_type!r}")
    return float(np.sum(weights * drift))


def split_chunks(video: np.ndarray, n_chunks: int = 10) -> np.ndarray:
    """[T, H, W, 3] -> [N, T//N, H, W, 3], trimming the remainder."""
    t = video.shape[0]
    per = t // n_chunks
    if per == 0:
        raise ValueError(f"{t} frames cannot be split into {n_chunks} chunks")
    return video[: per * n_chunks].reshape(n_chunks, per, *video.shape[1:])


# ---------------------------------------------------------------------------
# Built-in lightweight metrics
# ---------------------------------------------------------------------------

def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)` of a uint8 [H, W, 3] frame:
    OpenCV's 15-bit fixed-point weights (0.299, 0.587, 0.114 scaled by 2^15
    and rounded, summing to 2^15), rounded half up. Equal to cv2 on every
    one of the 2^24 RGB triples."""
    f = frame.astype(np.int32)
    return ((9798 * f[..., 0] + 19235 * f[..., 1] + 3735 * f[..., 2] + (1 << 14))
            >> 15).astype(np.uint8)


def laplacian(gray: np.ndarray) -> np.ndarray:
    """`cv2.Laplacian(gray, cv2.CV_64F)` (ksize 1): the 4-neighbour stencil
    over OpenCV's default border, BORDER_REFLECT_101 (numpy's "reflect").
    Every term is an integer, so the float64 sums are exact."""
    g = np.pad(gray.astype(np.float64), 1, mode="reflect")
    return (g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
            - 4.0 * g[1:-1, 1:-1])


def clarity(chunk: np.ndarray) -> float:
    """Sharpness proxy: mean Laplacian variance per frame (stands in for the
    reference's pyiqa MUSIQ model)."""
    scores = [laplacian(rgb_to_gray((frame * 255).astype(np.uint8))).var()
              for frame in chunk]
    return float(np.mean(scores))


def motion_smoothness(chunk: np.ndarray) -> float:
    """Second-difference smoothness: 1 / (1 + mean |f[t+1] - 2f[t] + f[t-1]|)."""
    if chunk.shape[0] < 3:
        return 1.0
    acc = np.abs(chunk[2:] - 2 * chunk[1:-1] + chunk[:-2]).mean()
    return float(1.0 / (1.0 + 10.0 * acc))


def dynamic_degree(chunk: np.ndarray) -> float:
    """Mean absolute inter-frame difference (motion amount)."""
    if chunk.shape[0] < 2:
        return 0.0
    return float(np.abs(np.diff(chunk, axis=0)).mean())


def subject_consistency(chunk: np.ndarray) -> float:
    """Frame-to-frame correlation of center-crop features (stands in for the
    reference's DINO subject consistency)."""
    t, h, w, _ = chunk.shape
    crop = chunk[:, h // 4: 3 * h // 4, w // 4: 3 * w // 4]
    flat = crop.reshape(t, -1)
    flat = flat - flat.mean(axis=1, keepdims=True)
    norm = np.linalg.norm(flat, axis=1) + 1e-8
    corr = (flat[:-1] * flat[1:]).sum(axis=1) / (norm[:-1] * norm[1:])
    return float(np.mean(corr)) if t > 1 else 1.0


def background_consistency(chunk: np.ndarray) -> float:
    """Border-region correlation (stands in for CLIP background consistency)."""
    t, h, w, _ = chunk.shape
    border = np.concatenate([
        chunk[:, : h // 8].reshape(t, -1),
        chunk[:, -h // 8:].reshape(t, -1),
    ], axis=1)
    border = border - border.mean(axis=1, keepdims=True)
    norm = np.linalg.norm(border, axis=1) + 1e-8
    corr = (border[:-1] * border[1:]).sum(axis=1) / (norm[:-1] * norm[1:])
    return float(np.mean(corr)) if t > 1 else 1.0


def brightness(chunk: np.ndarray) -> float:
    """Mean luminance (reference simple_brightness_metric,
    LV-Bench/metrics.py:13-15)."""
    return float(chunk.mean())


def aesthetic(chunk: np.ndarray) -> float:
    """Weight-free aesthetic proxy standing in for the LAION CLIP head
    (reference metrics.py:206-219): colorfulness (Hasler-Susstrunk) +
    global contrast + rule-of-thirds-agnostic exposure balance, each
    squashed to [0, 1] and averaged. The REAL model is pluggable via
    `eval.vbench_real.LAIONAesthetic`."""
    f = chunk.reshape(-1, *chunk.shape[-3:])
    rg = f[..., 0] - f[..., 1]
    yb = 0.5 * (f[..., 0] + f[..., 1]) - f[..., 2]
    colorfulness = np.sqrt(rg.std() ** 2 + yb.std() ** 2) \
        + 0.3 * np.sqrt(rg.mean() ** 2 + yb.mean() ** 2)
    lum = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    contrast = float(lum.std())
    exposure = 1.0 - abs(float(lum.mean()) - 0.5) * 2.0
    c1 = min(colorfulness / 0.3, 1.0)
    c2 = min(contrast / 0.25, 1.0)
    return float((c1 + c2 + max(exposure, 0.0)) / 3.0)


BUILTIN_METRICS: Dict[str, MetricFn] = {
    "brightness": brightness,
    "clarity": clarity,
    "motion": motion_smoothness,
    "aesthetic": aesthetic,
    "dynamic": dynamic_degree,
    "subject_consistency": subject_consistency,
    "background_consistency": background_consistency,
}


def create_metric_func(name: str, **kwargs) -> MetricFn:
    """Factory (reference metrics.py:145). Custom/VBench metrics can be
    registered into BUILTIN_METRICS."""
    if name not in BUILTIN_METRICS:
        raise ValueError(
            f"unknown metric {name!r}; available: {sorted(BUILTIN_METRICS)}"
        )
    return BUILTIN_METRICS[name]


def evaluate_video(
    video: np.ndarray,
    n_chunks: int = 10,
    metrics: Optional[Sequence[str]] = None,
    weight_type: str = "linear",
) -> Dict[str, float]:
    """Per-metric VDE for one video [T, H, W, 3] in [0, 1]."""
    metrics = metrics or list(BUILTIN_METRICS)
    chunks = split_chunks(video, n_chunks)
    return {
        m: vde(chunks, create_metric_func(m), weight_type) for m in metrics
    }


def quality_delta(
    video_a: np.ndarray, video_b: np.ndarray, n_chunks: int = 4,
    metrics: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Mean |score_a - score_b| per metric across chunks — the harness for
    tracking quantized-vs-bf16 quality deltas (BASELINE.md <=0.5 VBench d)."""
    metrics = metrics or list(BUILTIN_METRICS)
    ca, cb = split_chunks(video_a, n_chunks), split_chunks(video_b, n_chunks)
    out = {}
    for m in metrics:
        fn = create_metric_func(m)
        sa = np.asarray([fn(c) for c in ca])
        sb = np.asarray([fn(c) for c in cb])
        denom = np.abs(sa).mean() + 1e-8
        out[m] = float(np.abs(sa - sb).mean() / denom)
    return out
