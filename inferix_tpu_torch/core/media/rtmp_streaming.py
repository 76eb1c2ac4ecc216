"""RTMP streaming via an ffmpeg pipe (a copy of the JAX package's; parity with
`inferix/core/media/rtmp_streaming.py:19-164`). Requires the ffmpeg binary."""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import numpy as np

from .streaming_backend import StreamingBackend


class RTMPStreamingBackend(StreamingBackend):
    def __init__(self, url: str = "rtmp://localhost/live/stream",
                 fps: int = 16, width: int = 832, height: int = 480,
                 bitrate: str = "2M", **kwargs):
        super().__init__(**kwargs)
        self.url = url
        self.fps = fps
        self.width = width
        self.height = height
        self.bitrate = bitrate
        self._proc: Optional[subprocess.Popen] = None

    def connect(self) -> None:
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "ffmpeg binary not found; RTMP streaming unavailable in this "
                "environment — use the 'memory' or 'file' backend"
            )
        cmd = [
            "ffmpeg", "-y",
            "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{self.width}x{self.height}", "-r", str(self.fps),
            "-i", "-",
            "-c:v", "libx264", "-preset", "ultrafast", "-tune", "zerolatency",
            "-b:v", self.bitrate, "-f", "flv", self.url,
        ]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
        self.connected = True

    def stream_batch(self, frames: np.ndarray) -> None:
        if self._proc is None or self._proc.stdin is None:
            raise RuntimeError("backend not connected")
        frames = np.ascontiguousarray(np.asarray(frames, np.uint8))
        self._proc.stdin.write(frames.tobytes())

    def disconnect(self) -> None:
        if self._proc is not None:
            try:
                self._proc.stdin.close()
                self._proc.wait(timeout=10)
            except Exception:
                self._proc.kill()
            self._proc = None
        self.connected = False
