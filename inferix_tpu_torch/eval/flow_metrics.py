"""Weight-free VBench-style metric plug-ins for the VDE harness: the port's
copy of `inferix_tpu/eval/flow_metrics.py`, host numpy.

The reference scores LV-Bench with trained models (`LV-Bench/metrics.py:
13-260`); these are their weight-free stand-ins:

* dense pyramidal Lucas-Kanade optical flow (numpy), the classical estimator
  RAFT supersedes; consistent enough for drift tracking, which compares a
  chunk with chunk 0 of the same video;
* `optical_flow_dynamic_degree`: mean flow magnitude (RAFT dynamic degree);
* `optical_flow_motion_smoothness`: flow-compensated midpoint reconstruction
  error (AMT's interpolate-and-compare recipe);
* `musiq_style_clarity`: a multi-scale no-reference sharpness score
  (gradient energy, local contrast, spectral content at 3 scales).

`register_flow_metrics` installs them into `eval.vde.BUILTIN_METRICS` under
the LV-Bench names `clarity_musiq`, `motion_flow` and `dynamic_flow`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# dense pyramidal Lucas-Kanade
# ---------------------------------------------------------------------------

def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 3:
        return (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
                + 0.114 * frame[..., 2]).astype(np.float64)
    return frame.astype(np.float64)


def _box(img: np.ndarray, r: int) -> np.ndarray:
    """Separable box filter of radius r via cumulative sums."""
    for axis in (0, 1):
        c = np.cumsum(img, axis=axis)
        n = img.shape[axis]
        idx_hi = np.clip(np.arange(n) + r, 0, n - 1)
        idx_lo = np.arange(n) - r - 1
        hi = np.take(c, idx_hi, axis=axis)
        lo = np.where(
            (idx_lo < 0)[(slice(None),) + (None,) * (img.ndim - 1)]
            if axis == 0 else (idx_lo < 0)[None, :],
            0.0,
            np.take(c, np.clip(idx_lo, 0, n - 1), axis=axis),
        )
        img = hi - lo
    return img


def _downsample(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    v = img[:h, :w]
    return 0.25 * (v[0::2, 0::2] + v[1::2, 0::2] + v[0::2, 1::2]
                   + v[1::2, 1::2])


def _warp(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear backward warp: sample img at (y + v, x + u)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = np.clip(xx + u, 0, w - 1.001)
    sy = np.clip(yy + v, 0, h - 1.001)
    x0 = sx.astype(np.int64)
    y0 = sy.astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def lucas_kanade_flow(
    a: np.ndarray, b: np.ndarray, levels: int = 3, radius: int = 4,
    iters: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense flow a -> b, coarse-to-fine LK with box-window normal
    equations. Returns (u, v) pixel displacements at full resolution."""
    pyr_a, pyr_b = [_to_gray(a)], [_to_gray(b)]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape) < 16:
            break
        pyr_a.append(_downsample(pyr_a[-1]))
        pyr_b.append(_downsample(pyr_b[-1]))

    def fit(arr: np.ndarray, shape) -> np.ndarray:
        arr = arr[: shape[0], : shape[1]]
        py, px = shape[0] - arr.shape[0], shape[1] - arr.shape[1]
        if py or px:
            arr = np.pad(arr, ((0, py), (0, px)), mode="edge")
        return arr

    u = np.zeros_like(pyr_a[-1])
    v = np.zeros_like(pyr_a[-1])
    for lvl in range(len(pyr_a) - 1, -1, -1):
        ia, ib = pyr_a[lvl], pyr_b[lvl]
        if u.shape != ia.shape:
            # finer level: upsample the field and double the displacements
            u = fit(np.kron(u * 2.0, np.ones((2, 2))), ia.shape)
            v = fit(np.kron(v * 2.0, np.ones((2, 2))), ia.shape)
        for _ in range(iters):
            ib_w = _warp(ib, u, v)
            ix = np.gradient(ia, axis=1) * 0.5 + np.gradient(ib_w, axis=1) * 0.5
            iy = np.gradient(ia, axis=0) * 0.5 + np.gradient(ib_w, axis=0) * 0.5
            it = ib_w - ia
            ixx = _box(ix * ix, radius)
            iyy = _box(iy * iy, radius)
            ixy = _box(ix * iy, radius)
            ixt = _box(ix * it, radius)
            iyt = _box(iy * it, radius)
            det = ixx * iyy - ixy * ixy
            det = np.where(np.abs(det) < 1e-6, 1e-6, det)
            du = (-iyy * ixt + ixy * iyt) / det
            dv = (ixy * ixt - ixx * iyt) / det
            # clamp per-iteration update for stability
            u = u + np.clip(du, -2, 2)
            v = v + np.clip(dv, -2, 2)
    return u, v


# ---------------------------------------------------------------------------
# metrics (chunk [T, H, W, 3] in [0, 1] -> float)
# ---------------------------------------------------------------------------

def optical_flow_dynamic_degree(chunk: np.ndarray, stride: int = 1) -> float:
    """Mean flow magnitude in pixels/frame (reference RAFT dynamic degree,
    vbench dynamic_degree via LV-Bench/metrics.py:73-81)."""
    t = chunk.shape[0]
    if t < 2:
        return 0.0
    mags = []
    for i in range(0, t - stride, stride):
        u, v = lucas_kanade_flow(chunk[i], chunk[i + stride])
        mags.append(np.sqrt(u * u + v * v).mean())
    return float(np.mean(mags))


def optical_flow_motion_smoothness(chunk: np.ndarray) -> float:
    """Flow-compensated midpoint reconstruction (reference AMT
    interpolate-and-compare motion smoothness, LV-Bench/metrics.py:60-70):
    estimate flow f[t-1] -> f[t+1], reconstruct f[t] as the half-flow warp
    of f[t-1], and score 1/(1 + k*err). Motion-compensated — unlike a raw
    second difference it does NOT penalize fast-but-smooth motion."""
    t = chunk.shape[0]
    if t < 3:
        return 1.0
    errs = []
    m = 8  # border margin: warping is undefined where flow leaves the frame
    for i in range(1, t - 1, 2):
        a = _to_gray(chunk[i - 1])
        c = _to_gray(chunk[i + 1])
        u, v = lucas_kanade_flow(chunk[i - 1], chunk[i + 1])
        # pixels move half-way by t: sample t-1 a half-flow back, t+1 a
        # half-flow forward
        mid = _warp(a, -0.5 * u, -0.5 * v)
        mid2 = _warp(c, 0.5 * u, 0.5 * v)
        recon = 0.5 * (mid + mid2)
        err = np.abs(recon - _to_gray(chunk[i]))
        errs.append(err[m:-m, m:-m].mean() if min(err.shape) > 2 * m
                    else err.mean())
    return float(1.0 / (1.0 + 20.0 * np.mean(errs)))


def musiq_style_clarity(chunk: np.ndarray) -> float:
    """Multi-scale no-reference quality score in [0, 100] (MUSIQ-style
    multi-scale design; reference uses the trained MUSIQ transformer via
    pyiqa, LV-Bench/metrics.py:18-38). Per scale s in {1, 1/2, 1/4}:
    gradient energy (sharpness), local RMS contrast, and high-frequency
    spectral fraction; scales are averaged and squashed."""
    scores = []
    for frame in chunk[:: max(1, chunk.shape[0] // 5)]:
        g = _to_gray(frame)
        per_scale = []
        for _ in range(3):
            gx = np.gradient(g, axis=1)
            gy = np.gradient(g, axis=0)
            grad_energy = np.sqrt(gx * gx + gy * gy).mean()
            local_mean = _box(g, 3) / ((2 * 3 + 1) ** 2)
            contrast = np.sqrt(
                np.maximum(_box(g * g, 3) / ((2 * 3 + 1) ** 2)
                           - local_mean ** 2, 0.0)).mean()
            f = np.abs(np.fft.rfft2(g))
            h, w = f.shape
            hf = f[h // 4:, :].sum() + f[: h // 4, w // 2:].sum()
            hf_frac = hf / (f.sum() + 1e-8)
            per_scale.append(
                10.0 * grad_energy + 2.0 * contrast + 50.0 * hf_frac)
            if min(g.shape) < 32:
                break
            g = _downsample(g)
        scores.append(np.mean(per_scale))
    raw = float(np.mean(scores))
    return 100.0 * raw / (raw + 1.0)


def register_flow_metrics() -> None:
    """Install into the VDE metric registry (LV-Bench metric names)."""
    from .vde import BUILTIN_METRICS

    BUILTIN_METRICS["clarity_musiq"] = musiq_style_clarity
    BUILTIN_METRICS["motion_flow"] = optical_flow_motion_smoothness
    BUILTIN_METRICS["dynamic_flow"] = optical_flow_dynamic_degree
