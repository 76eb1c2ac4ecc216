"""Interactive generation session: thread-safe input queue, checkpoint
evaluation, pause / resume / stop (port of `inferix_tpu/core/interactive.py`).

Latest-wins input queue, `evaluate_checkpoint(boundary, idx)` returning a
`CheckpointResult`, pause / resume / stop events and a progress callback with
ETA. The port runs as one process, so the decision needs no broadcast:
`_broadcast_result` returns it unchanged (the JAX package broadcasts host 0's
decision to every host; a `torch.distributed` broadcast belongs to the
parallel layer, which is not ported).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .types import (
    CheckpointResult,
    GenerationCommand,
    GenerationStatus,
    InputApplyPolicy,
    QueuedInput,
)


class InteractiveSession:
    """Owns the mutable interaction state around the generator."""

    def __init__(
        self,
        apply_policy: InputApplyPolicy = InputApplyPolicy.NEXT_SEGMENT,
        status_callback: Optional[Callable[[GenerationStatus], None]] = None,
    ):
        self.apply_policy = apply_policy
        self.status_callback = status_callback
        self._lock = threading.Lock()
        self._pending: Optional[QueuedInput] = None
        self._pause_event = threading.Event()
        self._stop_event = threading.Event()
        self.status = GenerationStatus()

    # -- client side (UI thread) -------------------------------------------

    def submit_input(self, prompt: Optional[str] = None,
                     guidance_scale: Optional[float] = None) -> None:
        """Queue new input; latest submission wins (reference latest-wins
        queue semantics)."""
        with self._lock:
            self._pending = QueuedInput(
                prompt=prompt, guidance_scale=guidance_scale,
                apply_policy=self.apply_policy,
            )

    def pause(self) -> None:
        self._pause_event.set()

    def resume(self) -> None:
        self._pause_event.clear()

    def stop(self) -> None:
        self._stop_event.set()
        self._pause_event.clear()

    @property
    def is_paused(self) -> bool:
        return self._pause_event.is_set()

    @property
    def is_stopped(self) -> bool:
        return self._stop_event.is_set()

    # -- generation side (worker loop) -------------------------------------

    def _policy_matches(self, pending: QueuedInput, boundary: str) -> bool:
        """Whether the queued input's apply policy lets THIS boundary
        consume it: IMMEDIATE applies at any checkpoint, NEXT_BLOCK at
        block or segment boundaries, NEXT_SEGMENT only at segment
        boundaries (the reference's InputApplyPolicy contract,
        session.py apply-policy evaluation)."""
        policy = pending.apply_policy or self.apply_policy
        if policy == InputApplyPolicy.NEXT_SEGMENT:
            return boundary == "segment"
        return True  # IMMEDIATE / NEXT_BLOCK: any checkpoint qualifies

    def evaluate_checkpoint(self, boundary: str, index: int) -> CheckpointResult:
        """Called by the pipeline at segment/block boundaries. Consumes the
        queued input when the boundary satisfies the input's apply
        policy."""
        if self._stop_event.is_set():
            result = CheckpointResult(command=GenerationCommand.STOP)
        else:
            with self._lock:
                pending = self._pending
                if pending is not None and self._policy_matches(pending,
                                                                boundary):
                    self._pending = None
                else:
                    pending = None
            if pending is None:
                result = CheckpointResult(command=GenerationCommand.CONTINUE)
            elif pending.prompt is not None:
                result = CheckpointResult(
                    command=GenerationCommand.UPDATE_PROMPT,
                    new_prompt=pending.prompt,
                    new_guidance=pending.guidance_scale,
                )
            else:
                result = CheckpointResult(
                    command=GenerationCommand.UPDATE_GUIDANCE,
                    new_guidance=pending.guidance_scale,
                )
        return self._broadcast_result(result)

    def wait_if_paused(self, poll_s: float = 0.1) -> bool:
        """Block while paused; returns False if stopped while waiting."""
        while self._pause_event.is_set():
            if self._stop_event.is_set():
                return False
            self.status.is_paused = True
            self._report()
            time.sleep(poll_s)
        self.status.is_paused = False
        return not self._stop_event.is_set()

    def update_progress(self, segment: int = None, total_segments: int = None,
                        block: int = None, total_blocks: int = None,
                        frames: int = None) -> None:
        st = self.status
        if segment is not None:
            st.current_segment = segment
        if total_segments is not None:
            st.total_segments = total_segments
        if block is not None:
            st.current_block = block
        if total_blocks is not None:
            st.total_blocks = total_blocks
        if frames is not None:
            st.frames_generated = frames
        self._report()

    def _report(self) -> None:
        if self.status_callback is not None:
            try:
                self.status_callback(self.status)
            except Exception:
                pass

    # -- multi-host ---------------------------------------------------------

    def _broadcast_result(self, result: CheckpointResult) -> CheckpointResult:
        """Host 0's decision wins everywhere; with one process it is this
        process's decision."""
        return result
