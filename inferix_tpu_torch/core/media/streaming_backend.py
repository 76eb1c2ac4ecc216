"""Streaming backend ABC + factory (a copy of
`inferix_tpu/core/media/streaming_backend.py`; numpy only).

Parity with `inferix/core/media/streaming_backend.py:10-53`: backends
implement connect / stream_batch / disconnect and are created by name.
Backends whose dependencies are missing in the environment raise a helpful
error at construction, not import time.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Optional

import numpy as np


class StreamingBackend(abc.ABC):
    """Receives decoded uint8 frame batches and delivers them somewhere."""

    def __init__(self, **kwargs: Any):
        self.config = kwargs
        self.connected = False

    @abc.abstractmethod
    def connect(self) -> None:
        ...

    @abc.abstractmethod
    def stream_batch(self, frames: np.ndarray) -> None:
        """frames: [T, H, W, 3] uint8."""

    @abc.abstractmethod
    def disconnect(self) -> None:
        ...

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.disconnect()


class MemoryQueueBackend(StreamingBackend):
    """In-process backend: frames land in a thread-safe queue. Used by tests
    and programmatic consumers (and as the base for server push loops)."""

    def __init__(self, maxsize: int = 256, **kwargs):
        super().__init__(**kwargs)
        import queue

        self.queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=maxsize)
        self.frames_streamed = 0

    def connect(self) -> None:
        self.connected = True

    def stream_batch(self, frames: np.ndarray) -> None:
        if not self.connected:
            raise RuntimeError("backend not connected")
        frames = np.asarray(frames)
        assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
        for f in frames:
            self.queue.put(f)
        self.frames_streamed += len(frames)

    def disconnect(self) -> None:
        self.connected = False


def create_streaming_backend(name: str, **kwargs) -> StreamingBackend:
    """Factory (reference factory pattern). Names: memory | gradio | webrtc |
    rtmp | file."""
    name = name.lower()
    if name == "memory":
        return MemoryQueueBackend(**kwargs)
    if name == "gradio":
        from .gradio_streaming import GradioStreamingBackend

        return GradioStreamingBackend(**kwargs)
    if name == "webrtc":
        from .webrtc_streaming import WebRTCStreamingBackend

        return WebRTCStreamingBackend(**kwargs)
    if name == "rtmp":
        from .rtmp_streaming import RTMPStreamingBackend

        return RTMPStreamingBackend(**kwargs)
    if name == "file":
        from .video_utils import FileStreamingBackend

        return FileStreamingBackend(**kwargs)
    raise ValueError(f"unknown streaming backend {name!r}")


def latents_to_uint8(video: "np.ndarray") -> np.ndarray:
    """[B, T, H, W, 3] float in [0, 1] -> [T, H, W, 3] uint8 (batch 0)."""
    v = np.asarray(video)
    if v.ndim == 5:
        v = v[0]
    return np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
