"""The port's VDE harness (`inferix_tpu_torch/eval/vde.py`,
`eval/flow_metrics.py`) against the JAX package's, on the CPU.

Both are host numpy over the same seeded inputs, so every score, drift,
delta and flow field is held equal, exactly (tolerance 0): the port's copies
keep the arithmetic. The one rewritten metric, `clarity`, computes OpenCV's
gray conversion and Laplacian in numpy; it is held bit-equal to `cv2` (and
so to the JAX `clarity`, which calls cv2) on every RGB triple and on frames
of even, odd and one-pixel sizes. The port's metric registry is its own: a
fixture restores both packages' registries after each test that writes them.
"""
import numpy as np
import pytest

from inferix_tpu.eval import flow_metrics as jflow
from inferix_tpu.eval import vde as jvde
from inferix_tpu_torch.eval import flow_metrics as tflow
from inferix_tpu_torch.eval import vde as tvde

METRICS = ("brightness", "clarity", "motion", "aesthetic", "dynamic",
           "subject_consistency", "background_consistency")
FLOW_METRICS = ("optical_flow_dynamic_degree", "optical_flow_motion_smoothness",
                "musiq_style_clarity")


@pytest.fixture
def registries():
    """Both packages' BUILTIN_METRICS, restored after the test."""
    saved = [(reg, dict(reg)) for reg in (tvde.BUILTIN_METRICS, jvde.BUILTIN_METRICS)]
    yield
    for reg, old in saved:
        reg.clear()
        reg.update(old)


def _video(t=12, h=32, w=40, seed=0):
    """A moving smooth texture with noise, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 2 * t, w + 2 * t, 3))
    for _ in range(3):
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
    frames = np.stack([base[i:i + h, 2 * i:2 * i + w] for i in range(t)])
    frames = frames + 0.05 * rng.standard_normal(frames.shape)
    return np.clip(frames, 0, 1).astype(np.float32)


def test_metric_names_match():
    assert tuple(tvde.BUILTIN_METRICS) == METRICS == tuple(jvde.BUILTIN_METRICS)
    assert tvde.BUILTIN_METRICS is not jvde.BUILTIN_METRICS


@pytest.mark.parametrize("name", METRICS)
def test_builtin_metric_matches_jax(name):
    for chunk in (_video(t=4, seed=1), _video(t=2, h=9, w=7, seed=2), _video(t=1, seed=3)):
        assert tvde.create_metric_func(name)(chunk) == jvde.create_metric_func(name)(chunk)


def test_clarity_gray_is_cv2_on_every_rgb_triple():
    cv2 = pytest.importorskip("cv2")
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                               indexing="ij"), -1).reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(tvde.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 6), (2, 3), (7, 5), (48, 64), (33, 17)])
def test_clarity_laplacian_is_cv2(h, w):
    cv2 = pytest.importorskip("cv2")
    frame = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3), np.uint8)
    gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(tvde.rgb_to_gray(frame), gray)
    lap = cv2.Laplacian(gray, cv2.CV_64F)
    np.testing.assert_array_equal(tvde.laplacian(gray), lap)
    chunk = (frame[None] / 255.0).astype(np.float32)
    assert tvde.clarity(chunk) == jvde.clarity(chunk) == float(lap.var())


@pytest.mark.parametrize("weight_type", ["linear", "log"])
def test_vde_matches_jax(weight_type):
    chunks = tvde.split_chunks(_video(t=15, seed=4), 5)
    for name in ("brightness", "motion", "clarity"):
        fn = tvde.create_metric_func(name)
        assert tvde.vde(chunks, fn, weight_type) == jvde.vde(chunks, fn, weight_type)
    scores = iter([2.0, 2.2, 1.8, 2.0])
    n, drift = 4, np.abs(np.array([2.2, 1.8, 2.0]) - 2.0) / 2.0
    w = np.array([3.0, 2.0, 1.0]) if weight_type == "linear" else np.log([3.0, 2.0, 1.0])
    assert tvde.vde(np.zeros((n, 1, 1, 1, 3)), lambda c: next(scores), weight_type) \
        == pytest.approx(float(np.sum(w * drift)), rel=1e-15)
    zero_first = iter([0.0, 1.0])
    assert tvde.vde(np.zeros((2, 1, 1, 1, 3)), lambda c: next(zero_first)) == float("inf")
    assert tvde.vde(np.zeros((1, 1, 1, 1, 3)), lambda c: 1.0) == 0.0
    with pytest.raises(ValueError, match="weight type"):
        tvde.vde(np.zeros((2, 1, 1, 1, 3)), lambda c: 1.0, "cubic")


def test_split_chunks_matches_jax():
    video = _video(t=23, seed=5)
    for n in (1, 5, 23):
        np.testing.assert_array_equal(tvde.split_chunks(video, n), jvde.split_chunks(video, n))
    with pytest.raises(ValueError, match="cannot be split"):
        tvde.split_chunks(video, 24)


def test_evaluate_video_and_quality_delta_match_jax(registries):
    tflow.register_flow_metrics()
    jflow.register_flow_metrics()
    a, b = _video(t=12, seed=6), _video(t=12, seed=7)
    for weight_type in ("linear", "log"):
        got = tvde.evaluate_video(a, n_chunks=3, weight_type=weight_type)
        assert got == jvde.evaluate_video(a, n_chunks=3, weight_type=weight_type)
        assert set(got) == set(METRICS) | {"clarity_musiq", "motion_flow", "dynamic_flow"}
    got = tvde.quality_delta(a, b, n_chunks=3)
    assert got == jvde.quality_delta(a, b, n_chunks=3)
    assert all(v > 0 for v in got.values())
    assert all(v == 0.0 for v in tvde.quality_delta(a, a, n_chunks=4).values())
    sub = ["brightness", "dynamic_flow"]
    assert tvde.quality_delta(a, b, 4, sub) == jvde.quality_delta(a, b, 4, sub)


def test_lucas_kanade_flow_matches_jax():
    video = _video(t=2, h=64, w=72, seed=8)
    for kw in ({"levels": 2, "radius": 2, "iters": 1}, {}):
        tu, tv = tflow.lucas_kanade_flow(video[0], video[1], **kw)
        ju, jv = jflow.lucas_kanade_flow(video[0], video[1], **kw)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tv, jv)
    # the texture moves 2 px a frame to the left and 1 up
    assert abs(float(np.median(tu)) + 2.0) < 0.7 and abs(float(np.median(tv)) + 1.0) < 0.7


@pytest.mark.parametrize("name", FLOW_METRICS)
def test_flow_metric_matches_jax(name):
    for chunk in (_video(t=5, h=48, w=56, seed=9), _video(t=2, seed=10), _video(t=1, seed=11)):
        assert getattr(tflow, name)(chunk) == getattr(jflow, name)(chunk)


def test_registry_is_the_ports_own(registries):
    before = dict(jvde.BUILTIN_METRICS)
    tflow.register_flow_metrics()
    assert tvde.BUILTIN_METRICS["motion_flow"] is tflow.optical_flow_motion_smoothness
    assert tvde.BUILTIN_METRICS["clarity_musiq"] is tflow.musiq_style_clarity
    assert tvde.BUILTIN_METRICS["dynamic_flow"] is tflow.optical_flow_dynamic_degree
    assert jvde.BUILTIN_METRICS == before
    assert tvde.create_metric_func("dynamic_flow") is tflow.optical_flow_dynamic_degree
    with pytest.raises(ValueError, match="unknown metric"):
        tvde.create_metric_func("nope")
