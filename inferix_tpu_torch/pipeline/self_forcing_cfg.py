"""Self-Forcing CFG pipeline: many-step multistep sampling with classifier-free
guidance over a positive and a negative KV cache (port of
`inferix_tpu/pipeline/self_forcing_cfg.py`).

Per block, a full multistep sampler (UniPC or DPM++) runs with the guided
flow uncond + g * (cond - uncond), then a t=0 re-run writes the clean block
into both caches. The conditional and unconditional passes are ONE batched
forward over a cache of batch 2B: rows [0:B] hold the positive prompt's
stream, rows [B:2B] the negative prompt's, so a step is one model call.

Each sampler step writes its K/V into the cache slots of the block (the
port's forwards always write in place); the final re-run rewrites the same
slots in every layer before that layer reads them, so each step attends
over what the JAX step (`persist_kv=False`) attends over and the cache after
a block is the same.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import torch

from ..core.config import EngineConfig
from ..kvcache.cache import CrossAttnCache, KVCache, init_kv_cache
from ..models.schedulers.fm_solvers import FlowDPMSolverMultistep, FlowUniPCMultistep
from ..models.wan.causal_dit import (Params, dit_forward_inference, make_statics,
                                     precompute_crossattn_cache)
from ..ops.rope import build_rope_tables
from ..profiling.profiler import InferixProfiler
from ..utils.params import init_params
from .base import AbstractInferencePipeline


class CausalDiffusionPipeline(AbstractInferencePipeline):
    """CFG variant of the semi-AR loop (few-step DMD -> many-step CFG).

    dtype: the model's (bf16 by default: the attention kernel takes bf16 on
    the card; the JAX pipeline defaults to float32, which the port runs on
    the CPU)."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 params: Optional[Params] = None,
                 num_sampling_steps: int = 50,
                 sample_solver: str = "unipc",
                 text_encoder=None,
                 profiler: Optional[InferixProfiler] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        cfg = config or EngineConfig()
        super().__init__(cfg, profiler, device)
        self._params = params
        self._text_encoder = text_encoder
        self._dtype = dtype
        self.num_sampling_steps = num_sampling_steps
        if sample_solver == "unipc":
            self.solver = FlowUniPCMultistep.create(num_sampling_steps,
                                                    shift=cfg.runtime.timestep_shift)
        elif sample_solver in ("dpm++", "dpm"):
            self.solver = FlowDPMSolverMultistep.create(num_sampling_steps,
                                                        shift=cfg.runtime.timestep_shift)
        else:
            raise ValueError(f"unknown sample_solver {sample_solver!r}")

    def _initialize_pipeline(self) -> None:
        m, r = self.config.model, self.config.runtime
        if self._params is None:
            g = torch.Generator(device=self.device).manual_seed(r.seed)
            self._params = init_params(m, g, device=self.device, dtype=self._dtype)
        # batch 2B: [0:B] the positive stream, [B:2B] the negative one
        self.statics = make_statics(m, 2 * r.batch_size, m.num_frame_per_block,
                                    r.latent_height, r.latent_width, self._dtype)
        self.rope_tables = build_rope_tables(m.head_dim, m.rope_max_seq_len,
                                             device=self.device)
        self.frame_seq = self.statics.geo.frame_seq

    @torch.inference_mode()
    def _encode_prompts_pair(self, prompts: List[str],
                             negative_prompts: Optional[List[str]]) -> CrossAttnCache:
        """Positive and negative text features -> one batched cross-attention
        cache, rows [0:B] positive, [B:2B] negative. Without a text encoder
        both halves are zeros and CFG does nothing, so it warns."""
        m, r = self.config.model, self.config.runtime
        if self._text_encoder is not None:
            pos = self._text_encoder(prompts)
            neg = self._text_encoder(negative_prompts if negative_prompts
                                     else [""] * len(prompts))
            feats = torch.cat([pos.to(self.device, self._dtype),
                               neg.to(self.device, self._dtype)], dim=0)
        else:
            warnings.warn(
                "CausalDiffusionPipeline has no text encoder: prompts are "
                "ignored and CFG is a no-op (cond == uncond). Pass "
                "text_encoder= to enable guidance.", stacklevel=3)
            feats = torch.zeros(2 * r.batch_size, m.text_len, m.text_dim,
                                dtype=self._dtype, device=self.device)
        return precompute_crossattn_cache(self._params, m, feats)

    def _draw_noise(self, seed: int, shape: Sequence[int]) -> torch.Tensor:
        """The initial noise [B, F, H, W, C] in the model dtype: the
        pipeline's only random draw (a test replaces it)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                           device=self.device).to(self._dtype)

    @torch.inference_mode()
    def run_text_to_video(
        self,
        prompts: List[str],
        negative_prompts: Optional[List[str]] = None,
        num_frames: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: Optional[int] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Latents [B, F, H, W, C]. guidance_scale defaults to
        max(runtime.guidance_scale, 5)."""
        self.setup()
        r, m = self.config.runtime, self.config.model
        num_frames = num_frames or r.num_frames
        g = guidance_scale if guidance_scale is not None else max(r.guidance_scale, 5.0)
        fpb = m.num_frame_per_block
        if num_frames % fpb:
            raise ValueError(f"num_frames {num_frames} must be divisible by {fpb}")
        xattn = self._encode_prompts_pair(prompts, negative_prompts)
        cache = init_kv_cache(self.statics.spec, device=self.device)
        noise = self._draw_noise(seed if seed is not None else r.seed,
                                 (r.batch_size, num_frames, r.latent_height,
                                  r.latent_width, r.latent_channels))
        outputs = []
        for bi in range(num_frames // fpb):
            outputs.append(self._cfg_block(cache, xattn, noise[:, bi * fpb:(bi + 1) * fpb],
                                           bi * fpb * self.frame_seq, g))
        return torch.cat(outputs, dim=1)

    def _cfg_block(self, cache: KVCache, xattn: CrossAttnCache, noisy: torch.Tensor,
                   current_start: int, guidance: float) -> torch.Tensor:
        """The sampler over one block, then the clean t=0 re-run into both
        caches. Returns the block's latents."""
        b, f = noisy.shape[0], noisy.shape[1]
        latents = noisy
        state = self.solver.init_state(noisy.shape, device=self.device)
        for i in range(self.num_sampling_steps):
            t = torch.full((2 * b, f), float(self.solver.timesteps[i]),
                           dtype=torch.float32, device=self.device)
            flow, _ = dit_forward_inference(
                self._params, self.statics, self.rope_tables,
                torch.cat([latents, latents]), t, xattn, cache, current_start)
            # the difference in the model dtype, the guided flow in float32
            # (JAX's promotion by its float32 guidance scale)
            cond, uncond = flow[:b], flow[b:]
            guided = uncond.float() + guidance * (cond - uncond).float()
            latents, state = self.solver.step(guided, i, latents, state)
        t0 = torch.zeros((2 * b, f), dtype=torch.float32, device=self.device)
        dit_forward_inference(self._params, self.statics, self.rope_tables,
                              torch.cat([latents, latents]), t0, xattn, cache,
                              current_start, need_output=False)
        return latents

    def _generate_segment_with_streaming(self, prompt, initial_latent, stream_callback,
                                         segment_index, block_callback=None):
        return self.run_text_to_video([prompt])
