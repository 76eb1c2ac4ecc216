"""CausVid pipeline: multi-segment rollouts with the overlap re-encoded
through the VAE (port of `inferix_tpu/pipeline/causvid.py`).

Each segment runs the semi-AR generator over a fresh KV cache, with the
segment's start latents written first as a clean prefix; the boundary pixel
frame is then re-encoded through the VAE encoder and put before the last
overlap - 1 latents to form the next segment's start latents, so that the
next segment is grounded in decoded pixels. One prompt for every segment, or
one a segment. The CausVid model is the causal Wan backbone with CausVid's
generation settings, so the pipeline reuses `SelfForcingPipeline`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

from ..core.config import EngineConfig
from ..core.types import DecodeMode
from .self_forcing import SelfForcingPipeline


def causvid_config() -> EngineConfig:
    """CausVid generation defaults: 3-frame blocks, 21-frame segments, the
    DMD few-step schedule, a 3-frame overlap."""
    cfg = EngineConfig()
    cfg.runtime.overlap_frames = 3
    return cfg


class CausVidPipeline(SelfForcingPipeline):
    """Rollouts on top of the shared semi-AR generator."""

    def run_rollouts(
        self,
        prompts: Union[str, Sequence[str]],
        num_rollouts: int = 3,
        num_overlap_frames: int = 3,
        segment_callback: Optional[Callable] = None,
        seed: Optional[int] = None,
    ) -> List[torch.Tensor]:
        """Generate `num_rollouts` chained segments of
        `runtime.frames_per_segment` latent frames. Returns each segment's
        pixel video in [0, 1], the overlap's pixel frames trimmed from every
        segment but the last."""
        self.setup()
        if self._vae is None:
            raise ValueError("CausVid rollouts need a VAE (decode_mode is NO_DECODE "
                             "and none was given)")
        r = self.config.runtime
        if isinstance(prompts, str):
            prompts = [prompts] * num_rollouts
        if len(prompts) < num_rollouts:
            raise ValueError(f"{len(prompts)} prompts for {num_rollouts} rollouts")
        videos: List[torch.Tensor] = []
        start_latents: Optional[torch.Tensor] = None
        base_seed = seed if seed is not None else r.seed
        # pixel frames of the overlap: its first latent frame decodes to 1,
        # each later one to 4
        overlap_pixels = 4 * (num_overlap_frames - 1) + 1
        for seg in range(num_rollouts):
            # a fresh KV cache per segment
            self.kv_manager.clear()
            new_frames = r.frames_per_segment - (
                start_latents.shape[1] if start_latents is not None else 0)
            latents = self.run_text_to_video(
                [prompts[seg]], num_frames=new_frames, initial_latent=start_latents,
                decode_mode=DecodeMode.NO_DECODE, seed=base_seed + seg)
            video = self._decode_latent(self._vae, latents, DecodeMode.AFTER_ALL)
            if seg < num_rollouts - 1:
                start_latents = self._encode_start_latents(video, latents,
                                                           num_overlap_frames)
                videos.append(video[:, :video.shape[1] - overlap_pixels])
            else:
                videos.append(video)
            if segment_callback is not None:
                segment_callback(videos[-1], seg)
        return videos

    @torch.inference_mode()
    def _encode_start_latents(self, video: torch.Tensor, latents: torch.Tensor,
                              num_overlap_frames: int) -> torch.Tensor:
        """The boundary frame through the VAE encoder (one latent frame),
        followed by the last overlap - 1 generated latents."""
        boundary = video.shape[1] - (4 * (num_overlap_frames - 1) + 1)
        # back to the encoder's [-1, 1] pixel range
        frame = video[:, boundary:boundary + 1] * 2.0 - 1.0
        start_frame = self._vae.encode(frame.to(self._vae.dtype)).to(latents.dtype)
        if num_overlap_frames <= 1:
            # the re-encoded frame alone (a -0 slice would take every latent)
            return start_frame
        return torch.cat([start_frame, latents[:, -(num_overlap_frames - 1):]], dim=1)
