"""Core enums and dataclasses of the pipeline layer (port of
`inferix_tpu/core/types.py`).

A copy, not an import: the port never imports the JAX package. The enum
values are the JAX package's strings, so a config written by either package
loads in the other. Everything here is plain Python data.
"""
from __future__ import annotations

import enum
import dataclasses
import time
from typing import Any, Callable, Optional


class DecodeMode(str, enum.Enum):
    """When the VAE decode runs relative to the semi-AR denoise loop."""

    AFTER_ALL = "after_all"  # decode once after all latents are generated
    PER_BLOCK = "per_block"  # decode each block as it is produced (streaming)
    NO_DECODE = "no_decode"  # return latents only


class StreamingMode(str, enum.Enum):
    """How streaming segments balance latency vs memory."""

    TRUE_STREAMING = "true_streaming"   # decode per block immediately
    DEFERRED_DECODE = "deferred_decode"  # buffer latents, decode after segment
    AUTO = "auto"                        # pick based on available memory


class MemoryMode(str, enum.Enum):
    """Host/device memory pressure presets."""

    AGGRESSIVE = "aggressive"  # offload everything possible
    BALANCED = "balanced"
    RELAXED = "relaxed"        # keep everything on device


class GenerationCommand(str, enum.Enum):
    """Commands that an interactive session can issue at a checkpoint."""

    CONTINUE = "continue"
    UPDATE_PROMPT = "update_prompt"
    UPDATE_GUIDANCE = "update_guidance"
    PAUSE = "pause"
    STOP = "stop"


class InputApplyPolicy(str, enum.Enum):
    """When queued interactive input takes effect."""

    NEXT_SEGMENT = "next_segment"
    NEXT_BLOCK = "next_block"
    IMMEDIATE = "immediate"


@dataclasses.dataclass
class QueuedInput:
    """A user input queued for the next generation checkpoint."""

    prompt: Optional[str] = None
    guidance_scale: Optional[float] = None
    timestamp: float = dataclasses.field(default_factory=time.time)
    apply_policy: InputApplyPolicy = InputApplyPolicy.NEXT_SEGMENT


@dataclasses.dataclass
class CheckpointResult:
    """Decision produced by evaluating an interactive checkpoint."""

    command: GenerationCommand = GenerationCommand.CONTINUE
    new_prompt: Optional[str] = None
    new_guidance: Optional[float] = None


@dataclasses.dataclass
class GenerationStatus:
    """Progress snapshot reported to interactive clients."""

    current_segment: int = 0
    total_segments: int = 0
    current_block: int = 0
    total_blocks: int = 0
    frames_generated: int = 0
    is_paused: bool = False
    is_stopped: bool = False
    start_time: float = dataclasses.field(default_factory=time.time)

    @property
    def progress_percent(self) -> float:
        if self.total_segments <= 0:
            return 0.0
        seg_frac = self.current_segment / self.total_segments
        if self.total_blocks > 0:
            seg_frac += (self.current_block / self.total_blocks) / self.total_segments
        return min(100.0, 100.0 * seg_frac)

    @property
    def eta_seconds(self) -> Optional[float]:
        pct = self.progress_percent
        if pct <= 0:
            return None
        elapsed = time.time() - self.start_time
        return elapsed * (100.0 - pct) / pct


@dataclasses.dataclass
class SegmentBoundary:
    """Validated segment/block boundary configuration for streaming runs.

    Mirrors the boundary validation behavior of the reference pipeline
    (`inferix/pipeline/base_pipeline.py:936-1090`).
    """

    frames_per_segment: int
    frames_per_block: int
    overlap_frames: int = 0

    def __post_init__(self) -> None:
        if self.frames_per_block <= 0:
            raise ValueError("frames_per_block must be positive")
        if self.frames_per_segment % self.frames_per_block != 0:
            raise ValueError(
                f"frames_per_segment ({self.frames_per_segment}) must be a "
                f"multiple of frames_per_block ({self.frames_per_block})"
            )
        if self.overlap_frames < 0 or self.overlap_frames >= self.frames_per_segment:
            raise ValueError(
                f"overlap_frames ({self.overlap_frames}) must be in "
                f"[0, frames_per_segment)"
            )

    @property
    def blocks_per_segment(self) -> int:
        return self.frames_per_segment // self.frames_per_block

    def unique_frames(self, num_segments: int) -> int:
        if num_segments <= 0:
            return 0
        return (
            num_segments * self.frames_per_segment
            - (num_segments - 1) * self.overlap_frames
        )


BlockCallback = Callable[[Any, int], None]
StreamCallback = Callable[[Any], None]
