"""Gradio streaming + interactive UI backends (a copy of the JAX package's,
driving the port's `InteractiveSession`).

Parity with `inferix/core/media/gradio_streaming.py:12-206` (frame queue +
auto-refresh preview) and `interactive_gradio.py:39-371` (prompt submit,
pause/resume/stop wired to an InteractiveSession). Gradio is an optional
dependency — constructing these backends without it raises a clear error.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..interactive import InteractiveSession
from .streaming_backend import MemoryQueueBackend


def _require_gradio():
    try:
        import gradio  # noqa: F401

        return gradio
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use the 'memory' "
            "or 'file' streaming backend, or install gradio"
        ) from e


class GradioStreamingBackend(MemoryQueueBackend):
    """Live preview UI fed by the frame queue."""

    def __init__(self, port: int = 8000, fps: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.port = port
        self.fps = fps
        self._app = None
        self._thread: Optional[threading.Thread] = None

    def connect(self) -> None:
        gr = _require_gradio()
        super().connect()

        def frame_generator():
            while self.connected:
                try:
                    frame = self.queue.get(timeout=1.0)
                    yield frame
                except Exception:
                    continue

        with gr.Blocks(title="inferix-tpu stream") as app:
            gr.Markdown("# Live generation")
            image = gr.Image(label="stream", streaming=True)
            app.load(frame_generator, outputs=image)
        self._app = app
        self._thread = threading.Thread(
            target=lambda: app.launch(
                server_port=self.port, share=False, prevent_thread_lock=True
            ),
            daemon=True,
        )
        self._thread.start()

    def disconnect(self) -> None:
        super().disconnect()
        if self._app is not None:
            try:
                self._app.close()
            except Exception:
                pass


class InteractiveGradioBackend(GradioStreamingBackend):
    """Full interactive UI: live preview + prompt/guidance submit +
    pause/resume/stop buttons driving an InteractiveSession."""

    def __init__(self, session: InteractiveSession, port: int = 8000,
                 **kwargs):
        super().__init__(port=port, **kwargs)
        self.session = session

    def connect(self) -> None:
        gr = _require_gradio()
        MemoryQueueBackend.connect(self)
        session = self.session

        def frame_generator():
            while self.connected:
                try:
                    yield self.queue.get(timeout=1.0)
                except Exception:
                    continue

        def on_submit(prompt, guidance):
            session.submit_input(prompt=prompt or None,
                                 guidance_scale=float(guidance)
                                 if guidance else None)
            return f"queued: {prompt!r}"

        def status_text():
            st = session.status
            eta = st.eta_seconds
            return (f"segment {st.current_segment}/{st.total_segments} · "
                    f"{st.frames_generated} frames · "
                    f"{st.progress_percent:.0f}%"
                    + (f" · ETA {eta:.0f}s" if eta else ""))

        with gr.Blocks(title="inferix-tpu interactive") as app:
            gr.Markdown("# Interactive world simulation")
            with gr.Row():
                image = gr.Image(label="stream", streaming=True)
                with gr.Column():
                    prompt = gr.Textbox(label="prompt")
                    guidance = gr.Number(label="guidance", value=0.0)
                    submit = gr.Button("Submit")
                    with gr.Row():
                        pause = gr.Button("Pause")
                        resume = gr.Button("Resume")
                        stop = gr.Button("Stop")
                    status = gr.Textbox(label="status", interactive=False)
            submit.click(on_submit, inputs=[prompt, guidance], outputs=status)
            pause.click(lambda: (session.pause(), "paused")[1], outputs=status)
            resume.click(lambda: (session.resume(), "resumed")[1],
                         outputs=status)
            stop.click(lambda: (session.stop(), "stopping")[1], outputs=status)
            app.load(frame_generator, outputs=image)
            timer = gr.Timer(1.0)
            timer.tick(status_text, outputs=status)

        self._app = app
        self._thread = threading.Thread(
            target=lambda: app.launch(
                server_port=self.port, share=False, prevent_thread_lock=True
            ),
            daemon=True,
        )
        self._thread.start()
