"""ctypes bindings of the port's native host components (`frame_pipe.cpp`):
the frame ring buffer `FramePipe`, `rgb_to_i420` and `laplacian_var`.

The library is built with `g++` at first use, never at import, into
`inferix_tpu_torch/_build/` (`_build.load_host_library`); a failed build
raises with the compiler's output. There is no fallback: the numpy versions
`rgb_to_i420_reference` and `laplacian_var_reference` are the plain
references the tests hold the native code to.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Optional, Tuple

import numpy as np

from .. import _build

SRC = pathlib.Path(__file__).resolve().with_name("frame_pipe.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The native library, built and bound at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load_host_library(SRC)
            lib.fp_create.restype = ctypes.c_void_p
            lib.fp_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
            lib.fp_destroy.argtypes = [ctypes.c_void_p]
            lib.fp_push.restype = ctypes.c_int
            lib.fp_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.fp_pop.restype = ctypes.c_int
            lib.fp_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.fp_size.restype = ctypes.c_size_t
            lib.fp_size.argtypes = [ctypes.c_void_p]
            lib.fp_dropped.restype = ctypes.c_uint64
            lib.fp_dropped.argtypes = [ctypes.c_void_p]
            lib.rgb_to_i420.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
            lib.laplacian_var.restype = ctypes.c_double
            lib.laplacian_var.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


class FramePipe:
    """Single-producer single-consumer ring of `capacity` uint8 frames of
    [height, width, channels]; a push into a full ring returns False and
    counts the frame in `dropped`."""

    def __init__(self, capacity: int, height: int, width: int, channels: int = 3):
        self.shape = (height, width, channels)
        self.frame_bytes = height * width * channels
        self.capacity = capacity
        self._lib = get_lib()
        self._ptr = self._lib.fp_create(capacity, self.frame_bytes)
        if not self._ptr:
            raise MemoryError(f"FramePipe: cannot allocate {capacity} x {self.frame_bytes} bytes")

    def push(self, frame: np.ndarray) -> bool:
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.nbytes != self.frame_bytes:
            raise ValueError(f"frame {frame.shape} does not fit the pipe's {self.shape}")
        return bool(self._lib.fp_push(self._ptr, frame.tobytes()))

    def pop(self) -> Optional[np.ndarray]:
        out = ctypes.create_string_buffer(self.frame_bytes)
        if not self._lib.fp_pop(self._ptr, out):
            return None
        return np.frombuffer(out.raw, np.uint8).reshape(self.shape).copy()

    def __len__(self) -> int:
        return int(self._lib.fp_size(self._ptr))

    @property
    def dropped(self) -> int:
        return int(self._lib.fp_dropped(self._ptr))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.fp_destroy(self._ptr)
            self._ptr = None


def _rgb_bytes(frame: np.ndarray) -> bytes:
    """The [H, W, 3] frame as contiguous uint8 bytes, for the native code."""
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] frame, got {frame.shape}")
    return np.ascontiguousarray(frame, np.uint8).tobytes()


def rgb_to_i420(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[H, W, 3] uint8 -> (Y [H, W], U [H//2, W//2], V [H//2, W//2])."""
    data = _rgb_bytes(frame)
    h, w, _ = frame.shape
    lib = get_lib()
    y = ctypes.create_string_buffer(h * w)
    u = ctypes.create_string_buffer((h // 2) * (w // 2))
    v = ctypes.create_string_buffer((h // 2) * (w // 2))
    lib.rgb_to_i420(data, w, h, y, u, v)
    return (np.frombuffer(y.raw, np.uint8).reshape(h, w).copy(),
            np.frombuffer(u.raw, np.uint8).reshape(h // 2, w // 2).copy(),
            np.frombuffer(v.raw, np.uint8).reshape(h // 2, w // 2).copy())


def laplacian_var(frame: np.ndarray) -> float:
    """Sharpness of an [H, W, 3] uint8 frame: the variance of the Laplacian
    of its gray image over the interior pixels."""
    data = _rgb_bytes(frame)
    h, w, _ = frame.shape
    return float(get_lib().laplacian_var(data, w, h))


def rgb_to_i420_reference(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain numpy version of `rgb_to_i420`, in the same integer math
    (chroma from the floor of each 2x2 block's mean; an odd last row or
    column takes no chroma)."""
    h, w, _ = frame.shape
    f = frame.astype(np.int32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = np.clip((77 * r + 150 * g + 29 * b) >> 8, 0, 255).astype(np.uint8)
    blk = f[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2, 3).sum(axis=(1, 3)) >> 2
    rb, gb, bb = blk[..., 0], blk[..., 1], blk[..., 2]
    u = np.clip(((-43 * rb - 85 * gb + 128 * bb) >> 8) + 128, 0, 255).astype(np.uint8)
    v = np.clip(((128 * rb - 107 * gb - 21 * bb) >> 8) + 128, 0, 255).astype(np.uint8)
    return y, u, v


def laplacian_var_reference(frame: np.ndarray) -> float:
    """The plain numpy version of `laplacian_var` (numpy's two-pass variance,
    where the native code takes sum and sum of squares: ~1e-12 apart)."""
    gray = (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
            + 0.114 * frame[..., 2]).astype(np.float64)
    lap = (gray[:-2, 1:-1] + gray[2:, 1:-1] + gray[1:-1, :-2]
           + gray[1:-1, 2:] - 4 * gray[1:-1, 1:-1])
    return float(lap.var())
