"""Video IO + file streaming backend (a copy of the JAX package's
`core/media/video_utils.py`; parity with the reference's
`inferix/core/media/video_utils.py` save/export helpers).

`imageio` is optional: `save_video` imports it inside the `try` of its
imageio path, so without it an `.mp4` falls back to `.npz` as it does
without the ffmpeg plugin, an `.npz` needs no `imageio` at all, and another
format (a `.gif`) fails as it does in the JAX package. Reading a file that
is not an `.npz` needs `imageio`."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .streaming_backend import StreamingBackend


def save_video(frames: np.ndarray, path: str, fps: int = 16) -> str:
    """frames: [T, H, W, 3] uint8 (or float in [0,1])."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        np.savez_compressed(path, frames=frames, fps=fps)
        return path
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:
        if ext not in (".mp4", ".mkv", ".webm"):
            raise
        # no imageio or no ffmpeg plugin in this environment: fall back to .npz
        alt = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(alt, frames=frames, fps=fps)
        return alt


def load_video(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["frames"]
    import imageio

    return np.stack(list(imageio.mimread(path, memtest=False)))


class FileStreamingBackend(StreamingBackend):
    """Streams frames into a growing on-disk video (finalized at disconnect)."""

    def __init__(self, path: str = "stream_out.mp4", fps: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.path = path
        self.fps = fps
        self._frames = []

    def connect(self) -> None:
        self._frames = []
        self.frames_streamed = 0
        self.connected = True

    def stream_batch(self, frames: np.ndarray) -> None:
        self._frames.extend(np.asarray(frames))
        self.frames_streamed = len(self._frames)

    def disconnect(self) -> None:
        if self._frames:
            self.path = save_video(np.stack(self._frames), self.path, self.fps)
        self.connected = False
