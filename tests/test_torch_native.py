"""The port's native host components (`inferix_tpu_torch/native/`) against
the JAX package's, on the CPU.

The port builds its own copy of `frame_pipe.cpp` with `g++` at first use into
`inferix_tpu_torch/_build/`. `rgb_to_i420` and `laplacian_var` are held
bit-equal to the JAX package's native functions over even and odd frame
sizes; the numpy references are held to the native code, `rgb_to_i420`
bit-equal and `laplacian_var` within 1e-9 relative (numpy's two-pass
variance against the native sum and sum of squares). `FramePipe` keeps FIFO
order and counts what a full ring drops. Importing the package builds
nothing, and a failed build (a missing compiler, a broken source) raises with
the compiler's message.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from inferix_tpu import native as jnative
from inferix_tpu_torch import _build
from inferix_tpu_torch import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(16, 16), (15, 17), (1, 1), (2, 3), (3, 2), (61, 104), (480, 832)]


def _frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("h,w", SIZES)
def test_rgb_to_i420_matches_jax_and_reference(h, w):
    frame = _frame(h, w, h * 1000 + w)
    got = tnative.rgb_to_i420(frame)
    assert [p.shape for p in got] == [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    for mine, jax_native, ref in zip(got, jnative.rgb_to_i420(frame),
                                     tnative.rgb_to_i420_reference(frame)):
        np.testing.assert_array_equal(mine, jax_native)
        np.testing.assert_array_equal(mine, ref)
    y, u, v = tnative.rgb_to_i420(np.full((8, 8, 3), 100, np.uint8))
    assert abs(int(y[0, 0]) - 100) <= 2 and abs(int(u[0, 0]) - 128) <= 2 \
        and abs(int(v[0, 0]) - 128) <= 2


@pytest.mark.parametrize("h,w", SIZES[:2] + SIZES[5:])
def test_laplacian_var_matches_jax_and_reference(h, w):
    frame = _frame(h, w, h + w)
    got = tnative.laplacian_var(frame)
    assert got == jnative.laplacian_var(frame)
    assert got == pytest.approx(tnative.laplacian_var_reference(frame), rel=1e-9)
    assert got > tnative.laplacian_var(np.full((h, w, 3), 50, np.uint8)) == 0.0


@pytest.mark.parametrize("fn", [tnative.rgb_to_i420, tnative.laplacian_var])
def test_frames_other_than_rgb_are_refused(fn):
    for shape in ((8, 8), (8, 8, 1), (8, 8, 4)):
        with pytest.raises(ValueError, match="expected an \\[H, W, 3\\] frame"):
            fn(np.zeros(shape, np.uint8))


def test_frame_pipe_fifo_and_drop():
    pipe = tnative.FramePipe(capacity=3, height=4, width=5)
    frames = [np.full((4, 5, 3), i, np.uint8) for i in range(5)]
    assert [pipe.push(f) for f in frames] == [True, True, True, False, False]
    assert len(pipe) == 3 and pipe.dropped == 2
    out = [pipe.pop() for _ in range(4)]
    assert out[3] is None and len(pipe) == 0
    for i in range(3):
        np.testing.assert_array_equal(out[i], frames[i])
    assert pipe.push(frames[4]) and pipe.dropped == 2
    np.testing.assert_array_equal(pipe.pop(), frames[4])
    with pytest.raises(ValueError, match="does not fit"):
        pipe.push(np.zeros((4, 4, 3), np.uint8))


def test_import_builds_nothing():
    """A fresh interpreter imports the package with the compiler unreachable."""
    code = ("import subprocess\n"
            "def boom(*a, **k):\n"
            "    raise AssertionError('a build ran at import')\n"
            "subprocess.run = subprocess.Popen = boom\n"
            "import inferix_tpu_torch.native as n, inferix_tpu_torch._build as b\n"
            "assert n._lib is None and not b._LIBS\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "frame_pipe_copy.cpp"
    src.write_text(tnative.SRC.read_text())
    monkeypatch.setattr(_build, "HOST_CXX", "/nonexistent/g++")
    with pytest.raises(RuntimeError, match="/nonexistent/g\\+\\+ failed to build frame_pipe_copy"):
        _build.load_host_library(src)
    monkeypatch.setattr(_build, "HOST_CXX", "g++")
    broken = tmp_path / "broken_pipe.cpp"
    broken.write_text('extern "C" int f() { return undeclared; }\n')
    with pytest.raises(RuntimeError, match="(?s)failed to build broken_pipe.cpp.*undeclared"):
        _build.load_host_library(broken)
    assert not list((tmp_path / "build").iterdir())  # nothing half-written is left
