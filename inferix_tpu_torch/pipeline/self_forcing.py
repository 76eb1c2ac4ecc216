"""Self-Forcing pipeline: the semi-AR text-to-video path end to end (port of
`inferix_tpu/pipeline/self_forcing.py`).

Per-prompt noise, per-request KV cache slots, few-step denoising with
context re-runs (`SemiARGenerator`), the decode modes (AFTER_ALL / PER_BLOCK
/ NO_DECODE) through the Wan causal VAE, free-cache-before-VAE, block
callbacks, and segment-chained streaming with an overlap-latent carry
(TRUE_STREAMING decodes each block as it is produced, DEFERRED_DECODE each
segment after it).

What differs from the JAX pipeline:
- the VAE's conv impl is an argument of `CausalVAE` here, not a process-wide
  switch: `runtime.vae_conv_impl` applies to the VAE this pipeline builds,
  and a VAE handed in keeps its own. The halo kernels take bf16 on the card,
  so under "halo" and "halo_w8a8" the default VAE is built in bf16 (in f32
  under "xla", as in JAX);
- the JAX trace-time switches `set_fused_act_quant` and `set_rope_impl` have
  no counterpart: the port always takes the fused act-quant chain.

`set_disaggregated_decode(devices)` routes the TRUE_STREAMING block decode
to decode devices of its own (`parallel/disaggregated.py`): the stream
callback then gets `PixelTiles` (pixels in [0, 1] still on the decode
devices), and nothing in the block hook waits for the card.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.config import EngineConfig
from ..core.types import DecodeMode, StreamingMode
from ..kvcache.manager import KVCacheManager, KVCacheRequest
from ..parallel.disaggregated import DisaggregatedVAEDecoder
from ..models.wan.causal_dit import Params
from ..models.wan.vae import CausalVAE, VAEConfig
from ..profiling.profiler import STORE, InferixProfiler
from ..quant.api import quantize_params
from ..utils.checkpoint import load_self_forcing_checkpoint
from ..utils.params import init_params
from .base import AbstractInferencePipeline
from .semi_ar import SemiARGenerator

# The VAE dtype each conv impl runs in when the pipeline builds the VAE.
_VAE_DTYPE = {"xla": torch.float32, "shifted_matmul": torch.float32,
              "halo": torch.bfloat16, "halo_w8a8": torch.bfloat16}


class SelfForcingPipeline(AbstractInferencePipeline):
    """params: the generator's parameter tree (when None: loaded from
    `config.model_path` by `utils.checkpoint.load_self_forcing_checkpoint`,
    or drawn from `runtime.seed` when no path is set); vae: a `CausalVAE` (a default one, from seed 0, when None and
    decoding); text_encoder: a callable from prompts to text features
    [B, text_len, text_dim] (zeros when None)."""

    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        params: Optional[Params] = None,
        vae: Optional[CausalVAE] = None,
        text_encoder: Optional[Callable] = None,
        profiler: Optional[InferixProfiler] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ):
        super().__init__(config or EngineConfig(), profiler, device)
        self._params = params
        self._vae = vae
        self._text_encoder = text_encoder
        self._dtype = dtype
        self.generator: Optional[SemiARGenerator] = None
        self.kv_manager: Optional[KVCacheManager] = None
        # the disaggregated block decode (set_disaggregated_decode), or None
        self.disagg_decoder: Optional[DisaggregatedVAEDecoder] = None

    def set_disaggregated_decode(self, devices, tiles=None,
                                 overlap: int = 2) -> DisaggregatedVAEDecoder:
        """Route the TRUE_STREAMING block decode to `devices`, the latent
        width tiled over them (`parallel/disaggregated.py`): block i then
        decodes there while block i + 1 denoises on the generator's card.
        Stream callbacks get `PixelTiles` instead of a pixel tensor."""
        if self.generator is None:
            self.setup()
        assert self._vae is not None, (
            "the disaggregated decode needs a VAE (decode_mode NO_DECODE builds none: "
            "construct the pipeline with a vae)")
        self.disagg_decoder = DisaggregatedVAEDecoder(self._vae, devices, tiles=tiles,
                                                      overlap=overlap)
        return self.disagg_decoder

    # -- lifecycle ----------------------------------------------------------

    def _initialize_pipeline(self) -> None:
        cfg = self.config
        if self._params is None:
            if cfg.model_path:
                self._params = load_self_forcing_checkpoint(
                    cfg.model_path, cfg.model, dtype=self._dtype, device=self.device)
            else:
                g = torch.Generator(device=self.device).manual_seed(cfg.runtime.seed)
                self._params = init_params(cfg.model, g, device=self.device,
                                           dtype=self._dtype)
        if cfg.quant.enabled:
            self._params = quantize_params(self._params, cfg.quant)
        self.generator = SemiARGenerator(cfg, self._params, dtype=self._dtype,
                                         device=self.device)
        self.kv_manager = KVCacheManager(self.generator.statics.spec,
                                         device=self.device)
        if self._vae is None and cfg.runtime.decode_mode != DecodeMode.NO_DECODE:
            impl = cfg.runtime.vae_conv_impl
            self._vae = CausalVAE(VAEConfig(), dtype=_VAE_DTYPE[impl],
                                  device=self.device, conv_impl=impl)

    @property
    def vae(self) -> CausalVAE:
        return self._vae

    # -- text conditioning --------------------------------------------------

    def _encode_prompts(self, prompts: List[str]):
        """Text-encoder features -> per-layer cross-attn KV cache. Without a
        text encoder (tests, precomputed-embedding mode), zeros are used."""
        m, r = self.config.model, self.config.runtime
        if self._text_encoder is not None:
            feats = self._text_encoder(prompts)
        else:
            feats = torch.zeros(r.batch_size, m.text_len, m.text_dim,
                                dtype=self._dtype, device=self.device)
        return self.generator.encode_text_context(feats)

    # -- noise --------------------------------------------------------------

    def _draw_noise(self, seed: int, shape: Sequence[int]) -> Tuple[
            torch.Tensor, Optional[torch.Generator], Optional[list]]:
        """(initial noise [B, F, H, W, C] in the model dtype, the generator
        the renoise is drawn from, or the renoise itself: one list a block,
        as `SemiARGenerator.generate` takes it). Every random draw of a
        generation goes through here."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                            device=self.device).to(self._dtype)
        return noise, g, None

    # -- main entry ---------------------------------------------------------

    def run_text_to_video(
        self,
        prompts: List[str],
        num_frames: Optional[int] = None,
        initial_latent: Optional[torch.Tensor] = None,
        return_latents: bool = False,
        decode_mode: Optional[DecodeMode] = None,
        block_callback: Optional[Callable] = None,
        seed: Optional[int] = None,
    ):
        self.setup()
        r = self.config.runtime
        decode_mode = decode_mode or r.decode_mode
        num_frames = num_frames or r.num_frames

        self.profiler.start_session("text_to_video", prompts=len(prompts))
        requests = [KVCacheRequest(f"req_{i}") for i in range(r.batch_size)]
        for req in requests:
            self.kv_manager.allocate_slots(req)

        with self.profiler.stage("initialization"):
            xattn = self._encode_prompts(prompts)
            noise, generator, renoise = self._draw_noise(
                seed if seed is not None else r.seed,
                (r.batch_size, num_frames, r.latent_height, r.latent_width,
                 r.latent_channels))

        def timed_callback(block_latent, idx):
            # time_ms is the PER-BLOCK duration (the profiler summary /
            # analyzer / extract_metrics contract): the card's time of the
            # block's `semi_ar.block` span, read when the session ends
            self.profiler.record_block_spans(idx, block_latent.shape[1],
                                             STORE.last("semi_ar.block"))
            if block_callback is not None:
                return block_callback(block_latent, idx)

        with self.profiler.stage("diffusion_generation"):
            latents, cache = self.generator.generate(
                noise, xattn, generator=generator,
                initial_latent=initial_latent,
                cache=self.kv_manager.cache,
                block_callback=timed_callback,
                renoise=renoise,
            )
            self._sync()
        self.kv_manager.update(cache)
        del cache  # the manager holds the cache alone: clear() frees it

        if r.free_cache_before_vae and decode_mode != DecodeMode.NO_DECODE:
            self.kv_manager.clear()
        for req in requests:
            self.kv_manager.free(req)

        video = self._decode_latent(self._vae, latents, decode_mode)
        self.profiler.end_session()
        if decode_mode == DecodeMode.NO_DECODE:
            return latents
        if return_latents:
            return video, latents
        return video

    def run_image_to_video(self, prompts: List[str], image_latent: torch.Tensor,
                           **kwargs):
        """Image conditioning = a clean initial latent prefix (the encoded
        image or clip, `CausalVAE.encode`), written into the cache first."""
        return self.run_text_to_video(
            prompts, initial_latent=image_latent, **kwargs
        )

    # -- streaming segment hook ---------------------------------------------

    def _generate_segment_with_streaming(
        self,
        prompt: str,
        initial_latent: Optional[torch.Tensor],
        stream_callback: Optional[Callable],
        segment_index: int,
        block_callback: Optional[Callable] = None,
    ) -> torch.Tensor:
        """One segment with per-block streaming decode (TRUE_STREAMING) or
        buffered decode after the segment (DEFERRED_DECODE)."""
        r = self.config.runtime
        mode = self.resolve_streaming_mode()
        ninit = initial_latent.shape[1] if initial_latent is not None else 0
        new_frames = r.frames_per_segment - ninit

        decode_state = {"cache": None, "first": True}

        def stream_block(block_latent, idx):
            ok = True
            if block_callback is not None:
                ok = block_callback(block_latent, idx)
            if stream_callback is None:
                return ok
            if mode == StreamingMode.TRUE_STREAMING and self.disagg_decoder is not None:
                # on the decode devices, asynchronously: the callback gets the
                # tiles' pixels in [0, 1] there, and nothing here waits
                px, decode_state["cache"] = self.disagg_decoder.decode_chunk(
                    block_latent, decode_state["cache"], first=decode_state["first"])
                decode_state["first"] = False
                stream_callback(px)
            elif mode == StreamingMode.TRUE_STREAMING and self._vae is not None:
                # whole-block decode, carrying the temporal cache from block
                # to block: equal to vae.decode of the segment's new latents
                out, decode_state["cache"] = self._vae.decode_chunk(
                    block_latent, decode_state["cache"],
                    first=decode_state["first"],
                )
                decode_state["first"] = False
                stream_callback(torch.clamp(out, -1, 1) * 0.5 + 0.5)
            return ok

        latents = self.run_text_to_video(
            [prompt],
            num_frames=new_frames,
            initial_latent=initial_latent,
            decode_mode=DecodeMode.NO_DECODE,
            block_callback=stream_block,
            seed=r.seed + segment_index,
        )

        if mode == StreamingMode.DEFERRED_DECODE and stream_callback is not None \
                and self._vae is not None:
            # stream only the NEW frames: the returned latents carry the
            # overlap prefix, which the previous segment already streamed
            video = self._decode_latent(self._vae, latents[:, ninit:],
                                        DecodeMode.AFTER_ALL)
            stream_callback(video)
        return latents
