"""WebRTC streaming (a copy of the JAX package's; parity with `inferix/core/media/webrtc_streaming.py:
18-163`, fastrtc-based). fastrtc is optional; missing -> clear error."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .streaming_backend import MemoryQueueBackend


class WebRTCStreamingBackend(MemoryQueueBackend):
    def __init__(self, port: int = 8001, fps: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.port = port
        self.fps = fps
        self._stream = None

    def connect(self) -> None:
        try:
            from fastrtc import Stream
        except ImportError as e:
            raise RuntimeError(
                "fastrtc is not installed; WebRTC streaming unavailable — "
                "use the 'memory' or 'file' backend"
            ) from e
        super().connect()

        backend = self

        def frame_source():
            while backend.connected:
                try:
                    yield backend.queue.get(timeout=1.0)
                except Exception:
                    continue

        self._stream = Stream(handler=frame_source, modality="video",
                              mode="send")
        import threading

        threading.Thread(
            target=lambda: self._stream.ui.launch(
                server_port=self.port, prevent_thread_lock=True
            ),
            daemon=True,
        ).start()

    def disconnect(self) -> None:
        super().disconnect()
        self._stream = None
