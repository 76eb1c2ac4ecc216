"""Framework pipeline API: lifecycle, decode-mode dispatch, segment-chained
streaming, interactive generation (port of `inferix_tpu/pipeline/base.py`).

`__call__ -> setup -> run -> run_text_to_video / run_image_to_video`,
`run_streaming_generation` (a segment loop with an overlap-latent carry),
`run_interactive_generation` (session checkpoints, pause and stop), segment
boundary validation, memory-mode presets and `_decode_latent` for the three
DecodeModes. All of it is plain Python orchestration around the generator
and the VAE; a pipeline runs on one device (`device`, default "cuda").
"""
from __future__ import annotations

import abc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.config import EngineConfig
from ..core.device import resolve_device
from ..core.interactive import InteractiveSession
from ..core.types import (
    DecodeMode,
    GenerationCommand,
    MemoryMode,
    SegmentBoundary,
    StreamingMode,
)
from ..profiling.profiler import InferixProfiler


class AbstractInferencePipeline(abc.ABC):
    """Base class for model pipelines."""

    def __init__(self, config: EngineConfig,
                 profiler: Optional[InferixProfiler] = None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.profiler = profiler or InferixProfiler()
        # the profiler reads this device's memory and waits for it before it
        # reads the clock
        self.profiler.device = self.device
        self._setup_done = False

    # -- lifecycle ----------------------------------------------------------

    def _sync(self) -> None:
        """Wait for the device's queued work (the JAX block_until_ready)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *args, **kwargs):
        self.setup()
        return self.run(*args, **kwargs)

    def setup(self) -> None:
        if not self._setup_done:
            self._initialize_pipeline()
            self._setup_done = True

    @abc.abstractmethod
    def _initialize_pipeline(self) -> None:
        """Build/load models (weights, text encoder, VAE)."""

    def run(self, prompts: List[str], **kwargs):
        return self.run_text_to_video(prompts, **kwargs)

    @abc.abstractmethod
    def run_text_to_video(self, prompts: List[str], **kwargs):
        ...

    def run_image_to_video(self, prompts: List[str], image, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} has no i2v path")

    # -- segment generation hook (implemented by model pipelines) -----------

    @abc.abstractmethod
    def _generate_segment_with_streaming(
        self,
        prompt: str,
        initial_latent: Optional[torch.Tensor],
        stream_callback: Optional[Callable],
        segment_index: int,
        block_callback: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Generate one segment of latents, optionally streaming decoded
        blocks through stream_callback. Returns the segment latents
        [B, F, H, W, C]."""

    # -- streaming orchestration (reference base_pipeline.py:468-615) --------

    def run_streaming_generation(
        self,
        prompts: List[str],
        num_segments: int,
        stream_callback: Optional[Callable] = None,
        segment_callback: Optional[Callable] = None,
        offload_segments: bool = False,
    ) -> List[torch.Tensor]:
        """Unbounded video via fixed-length segments with overlap-latent
        carry; prompts cycle per segment.

        offload_segments=True moves each finished segment's latents to CPU
        tensors (only the overlap carry stays on the device): without it a
        long run accumulates every segment in device memory."""
        boundary = self._boundary()
        overlap = boundary.overlap_frames

        segments: List[torch.Tensor] = []
        initial_latent: Optional[torch.Tensor] = None
        self.profiler.start_session("streaming_generation",
                                    num_segments=num_segments)
        for seg in range(num_segments):
            prompt = prompts[seg % len(prompts)]
            ninit = initial_latent.shape[1] if initial_latent is not None else 0
            with self.profiler.stage(f"segment_{seg}"):
                latents = self._generate_segment_with_streaming(
                    prompt, initial_latent, stream_callback, seg
                )
            if overlap > 0:
                initial_latent = latents[:, -overlap:]
            # segments hold only NEWLY generated frames: generate() prepends
            # the carried overlap prefix, which would otherwise be duplicated
            # across concatenated segments (reference streams decoded blocks
            # only, base_pipeline.py:605-607)
            latents = latents[:, ninit:] if ninit else latents
            if offload_segments:
                latents = latents.to("cpu")
            segments.append(latents)
            if segment_callback is not None:
                segment_callback(latents, seg)
        self.profiler.end_session()
        return segments

    # -- interactive orchestration (reference base_pipeline.py:747-934) ------

    def run_interactive_generation(
        self,
        session: InteractiveSession,
        initial_prompt: str,
        num_segments: int,
        stream_callback: Optional[Callable] = None,
    ) -> List[torch.Tensor]:
        boundary = self._boundary()
        overlap = boundary.overlap_frames
        prompt = initial_prompt
        guidance = self.config.runtime.guidance_scale

        segments: List[torch.Tensor] = []
        initial_latent: Optional[torch.Tensor] = None
        session.update_progress(segment=0, total_segments=num_segments,
                                total_blocks=boundary.blocks_per_segment)
        for seg in range(num_segments):
            result = session.evaluate_checkpoint("segment", seg)
            if result.command == GenerationCommand.STOP:
                break
            if result.command == GenerationCommand.UPDATE_PROMPT:
                prompt = result.new_prompt or prompt
                if result.new_guidance is not None:
                    guidance = result.new_guidance
            elif result.command == GenerationCommand.UPDATE_GUIDANCE:
                if result.new_guidance is not None:
                    guidance = result.new_guidance
            if not session.wait_if_paused():
                break

            def block_checkpoint(block_latent, idx):
                # block-granular stop (InputApplyPolicy.NEXT_BLOCK): pausing
                # blocks here; a stop aborts the segment at this boundary
                if not session.wait_if_paused():
                    return False
                session.update_progress(block=idx + 1)
                return not session.is_stopped

            ninit = initial_latent.shape[1] if initial_latent is not None else 0
            latents = self._generate_segment_with_streaming(
                prompt, initial_latent, stream_callback, seg,
                block_callback=block_checkpoint,
            )
            if overlap > 0:
                initial_latent = latents[:, -overlap:]
            segments.append(latents[:, ninit:] if ninit else latents)
            session.update_progress(
                segment=seg + 1,
                frames=sum(s.shape[1] for s in segments),
            )
        session.status.is_stopped = session.is_stopped
        return segments

    # -- boundary validation (reference base_pipeline.py:936-1090) -----------

    def _boundary(self) -> SegmentBoundary:
        r, m = self.config.runtime, self.config.model
        return SegmentBoundary(
            frames_per_segment=r.frames_per_segment,
            frames_per_block=m.num_frame_per_block,
            overlap_frames=r.overlap_frames,
        )

    # -- memory / streaming mode presets -------------------------------------

    def resolve_streaming_mode(self) -> StreamingMode:
        """AUTO picks TRUE_STREAMING when the card has headroom for generator
        + VAE concurrently (8 GiB free), DEFERRED_DECODE otherwise (reference
        VRAM-based auto-select, `pipeline/self_forcing/pipeline.py:502-547`).
        Free is what `torch.cuda.mem_get_info` reports plus what PyTorch
        holds reserved but unallocated. On the CPU: DEFERRED_DECODE, as the
        JAX package picks where its device reports no memory stats."""
        mode = self.config.runtime.streaming_mode
        if mode != StreamingMode.AUTO:
            return mode
        free_gb = 0.0
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            cached = (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
            free_gb = (free + cached) / 2**30
        return (StreamingMode.TRUE_STREAMING if free_gb >= 8.0
                else StreamingMode.DEFERRED_DECODE)

    def apply_memory_mode(self) -> Dict[str, Any]:
        """Map MemoryMode presets to engine knobs (reference
        base_pipeline.py:1188-1215)."""
        mode = self.config.runtime.memory_mode
        presets = {
            MemoryMode.AGGRESSIVE: dict(free_cache_before_vae=True,
                                        vae_chunk_size=1, kv_offload=True),
            MemoryMode.BALANCED: dict(free_cache_before_vae=True,
                                      vae_chunk_size=2, kv_offload=False),
            MemoryMode.RELAXED: dict(free_cache_before_vae=False,
                                     vae_chunk_size=4, kv_offload=False),
        }
        return presets[mode]

    # -- decode-mode dispatch (reference base_pipeline.py:1217-1271) ----------

    def _decode_latent(
        self,
        vae,
        latents: torch.Tensor,
        decode_mode: Optional[DecodeMode] = None,
    ) -> Optional[torch.Tensor]:
        decode_mode = decode_mode or self.config.runtime.decode_mode
        if decode_mode == DecodeMode.NO_DECODE:
            return None
        if decode_mode == DecodeMode.PER_BLOCK:
            # streaming path: per-block decode happens in the block callback;
            # here nothing remains to decode
            return None
        with self.profiler.stage("vae_decoding"):
            video = vae.decode(latents)
        return video * 0.5 + 0.5  # [-1,1] -> [0,1]
