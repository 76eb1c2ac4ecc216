"""Semi-autoregressive block-diffusion loop (port of
`inferix_tpu/pipeline/semi_ar.py:SemiARGenerator`).

Per block of `num_frame_per_block` latent frames:
  1. a few-step flow-match denoise, renoising between steps;
  2. the final x0 prediction is the block's output;
  3. the block's K/V is persisted for the later blocks: by a re-run at
     t=context_noise on the clean x0 (context_mode "rerun", the default), or
     by the final denoise step itself ("last_step", one forward fewer).

The JAX package bounds each block's attention grid by a power-of-two span
bucket (`span_bucket`, `max_span`), because a TPU grid is fixed when the
kernel is compiled. The port's CUDA kernel reads the live span from a device
tensor and loops over that span only, so there are no buckets and no host
sync here.

The KV cache is bf16, or with `quant.quantize_kv_cache` int8 with scales or
scale-free fp8 e4m3 (`quant.kv_cache_dtype`); `model.local_attn_size` sets a
rolling window with `model.sink_size` pinned frames, whose ring the cache
wraps around once the clip outgrows it.

W8A8: a tree quantized by `quant.api.quantize_params` runs every block
linear through the int8 GEMM kernel, each input quantized by the fused
act-quant or LN+modulate+quant kernel. Each rank runs its own token rows
through them, so the fused path is always taken (the JAX package turns it
off on multi-device meshes, and on one device takes it only with
`set_fused_act_quant(True)`).

`runtime.kv_head_major` / `kv_alloc_pad` choose the cache's layouts
(`kvcache/cache.py`). Parallelism: pass a mesh (`parallel.mesh.make_mesh`),
one process a rank, every rank calling the generator with the same inputs.
- sp > 1: `parallel.sp_mode` "ulysses", "ring" / "ring_pass_q" or
  "ring_pass_kv" picks the attention island, and "auto" (or a mesh of one)
  runs none, as in the JAX generator;
- tp > 1: the rank holds its tp shard of the tree
  (`parallel.mesh.wan_param_shards`; q/k/v stay unfused, as in the JAX
  generator) and of the text K/V; "ulysses" on a tp-only mesh runs the
  island too (`semi_ar.py:118-131`);
- dp > 1: each rank runs its B / dp batch rows. The inputs are the whole
  batch's: the noise and every renoise are drawn for all B rows, then
  sliced, so a dp run equals the one-device run row for row; each block's
  x0 is gathered over dp;
- pp > 1 without an island: the layers run as a GPipe pipeline, the batch
  rows its microbatches (`models.wan.causal_dit`); the rank holds its
  stage's layers of the tree, the text K/V and the cache. With an island
  every pp rank holds the whole stack, as the JAX package runs it.
Each rank holds only its shard of the cache (`init_cache`) and returns the
whole latents.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.config import EngineConfig
from ..core.device import resolve_device
from ..kvcache.cache import CrossAttnCache, KVCache
from ..models.schedulers.flow_match import FlowMatchSchedule, warp_denoising_steps
from ..models.wan.causal_dit import (Params, dit_forward_inference,
                                     fuse_qkv_params, make_statics,
                                     precompute_crossattn_cache)
from ..ops.flash_attention import DEFAULT_KV_BLOCK
from ..ops.rope import build_rope_tables
from ..parallel.distributed_attention import MODES, sp_comm_bytes_per_layer
from ..parallel.mesh import as_mesh, init_kv_cache_shard, wan_param_shards
from ..parallel.pipeline_parallel import stage_layers
from ..profiling.profiler import span
from ..quant.api import to_kernel_layout


class SemiARGenerator:
    """Generates latents block by block over one KV cache, on one device or
    on this rank of a mesh (`parallel.mesh.Mesh`, or an `SPMesh` of sp
    ranks)."""

    def __init__(self, cfg: EngineConfig, params: Params,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 mesh=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        m, r, qc = cfg.model, cfg.runtime, cfg.quant
        # KV cache storage (JAX `semi_ar.py:139-146`): int8 + scales
        # (in-kernel dequantization) or scale-free fp8 e4m3 (cast-only);
        # both halve the cache's bytes, so they buy capacity for streams
        quant_kv = qc.enabled and qc.quantize_kv_cache
        if quant_kv and qc.kv_cache_dtype not in ("int8", "fp8"):
            raise ValueError("kv_cache_dtype must be 'int8' or 'fp8', "
                             f"got {qc.kv_cache_dtype!r}")
        fp8_kv = quant_kv and qc.kv_cache_dtype == "fp8"
        mesh = as_mesh(mesh)
        tp = mesh.tp.size if mesh is not None else 1
        # the island (JAX `semi_ar.py:118-131`): a listed mode on a mesh of
        # sp > 1, "ulysses" on a tp-only mesh; "auto" and a mesh of one run none
        sp_mode = "none"
        if mesh is not None and cfg.parallel.sp_mode in MODES:
            if mesh.sp.size > 1:
                sp_mode = cfg.parallel.sp_mode
            elif tp > 1 and cfg.parallel.sp_mode == "ulysses":
                sp_mode = "ulysses"
        if mesh is not None and mesh.pp.size > 1 and sp_mode == "none":
            params = {**params, "blocks": stage_layers(params["blocks"], mesh, m.num_layers)}
        # q/k/v fused into one [D, 3D] projection, as the JAX generator does
        # (kept apart under tp, whose column shards split each projection);
        # int8 weights then held once, in the int8 GEMM's K-contiguous layout
        if tp > 1:
            params = wan_param_shards(params, mesh)
        elif m.fuse_qkv:
            params = fuse_qkv_params(params)
        self.params = to_kernel_layout(params)
        self.mesh, self.sp_mode = mesh, sp_mode
        # data parallel: `rows`, the batch rows this rank runs (None: all)
        self.batch = r.batch_size
        self._dp = mesh.dp if mesh is not None and mesh.dp.size > 1 else None
        self.rows, local_batch = None, self.batch
        if self._dp is not None:
            if self.batch % self._dp.size:
                raise ValueError(f"batch {self.batch} does not split over dp {self._dp.size}")
            local_batch = self.batch // self._dp.size
            self.rows = slice(self._dp.rank * local_batch, (self._dp.rank + 1) * local_batch)
        self.statics = make_statics(
            m, local_batch, m.num_frame_per_block, r.latent_height,
            r.latent_width, dtype, quantized_kv=quant_kv and not fp8_kv,
            kv_dtype=torch.float8_e4m3fn if fp8_kv else None, mesh=mesh, sp_mode=sp_mode,
            kv_head_major=r.kv_head_major,
            kv_alloc_multiple=DEFAULT_KV_BLOCK if r.kv_alloc_pad else 0)
        # the JAX package's count of one layer's attention exchange a forward
        self.sp_comm_bytes = sp_comm_bytes_per_layer(
            sp_mode, mesh.sp.size if mesh is not None else 1, tp, r.batch_size,
            self.statics.geo.tokens, self.statics.spec.max_tokens, m.num_heads,
            m.head_dim, itemsize=torch.empty((), dtype=dtype).element_size())
        self.rope_tables = build_rope_tables(m.head_dim, m.rope_max_seq_len,
                                             device=self.device)
        self.schedule = FlowMatchSchedule.create(shift=r.timestep_shift,
                                                 device=self.device)
        if r.warp_denoising_step:
            self.denoising_steps = warp_denoising_steps(
                self.schedule, r.denoising_step_list)
        else:
            self.denoising_steps = tuple(float(s) for s in r.denoising_step_list)
        self.context_noise = float(r.context_noise)
        self.frame_seq = self.statics.geo.frame_seq
        if r.context_mode not in ("rerun", "last_step"):
            raise ValueError("context_mode must be 'rerun' or 'last_step', "
                             f"got {r.context_mode!r}")
        self.context_mode = r.context_mode

    def init_cache(self) -> KVCache:
        """The cache, or on a mesh this rank's shard of it."""
        return init_kv_cache_shard(self.statics.spec, self.statics.shard, self.device)

    def _local(self, x):
        """This dp rank's rows of a whole-batch tensor or sequence (x as it
        is without dp, or when it has no row a slot: a batch of one)."""
        if self.rows is None or x is None or len(x) != self.batch:
            return x
        return x[self.rows]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows, in batch order."""
        return x if self._dp is None else torch.cat(self._dp.all_gather(x), dim=0)

    def encode_text_context(self, context: torch.Tensor,
                            clip_features: Optional[torch.Tensor] = None) -> CrossAttnCache:
        """context: [B, text_len, text_dim] text-encoder features; for an
        i2v model, clip_features [B, 257, 1280] add the image K/V. Under dp
        the rank's rows are kept; under tp the rank's heads."""
        tp = self.mesh.tp if self.mesh is not None else None
        with torch.inference_mode(), span("dit.text"):
            return precompute_crossattn_cache(
                self.params, self.cfg.model, self._local(context).to(self.device),
                None if clip_features is None else self._local(clip_features).to(self.device),
                tp=tp)

    def _start_tokens(self, current_start_frame):
        """A block's token offset: an int, or a [B] CPU tensor (one start a
        stream; its values are read on the host without a device sync)."""
        if isinstance(current_start_frame, int):
            return current_start_frame * self.frame_seq
        starts = torch.as_tensor(current_start_frame, device="cpu").to(torch.long)
        if starts.dim() == 0:
            return int(starts) * self.frame_seq
        return self._local(starts) * self.frame_seq

    def _renoise(self, x0: torch.Tensor, generator) -> torch.Tensor:
        """Fresh noise shaped like x0: from one generator for the batch, or
        with a sequence, each row from its own generator (zeros where it is
        None: an idle slot), so that a stream's draws do not depend on its
        neighbours. Under dp the whole batch's draw is made and sliced (one
        generator), or the rank's rows' generators draw."""
        if generator is None or isinstance(generator, torch.Generator):
            rows = self.batch if self.rows is not None else x0.shape[0]
            return self._local(torch.randn((rows,) + tuple(x0.shape[1:]), generator=generator,
                                           dtype=torch.float32,
                                           device=self.device)).to(x0.dtype)
        generator = self._local(list(generator))
        if len(generator) != x0.shape[0]:
            raise ValueError(f"{len(generator)} generators for a batch of {x0.shape[0]}")
        rows = [torch.zeros(x0.shape[1:], dtype=torch.float32, device=self.device)
                if g is None else
                torch.randn(x0.shape[1:], generator=g, dtype=torch.float32,
                            device=self.device) for g in generator]
        return torch.stack(rows).to(x0.dtype)

    def _forward(self, x, t_val, xattn, cache, start, need_output=True):
        """One DiT forward. Its callers open its `dit.forward` span, with
        the denoise step's index (-1 for a context forward)."""
        b, f = x.shape[0], x.shape[1]
        t = torch.full((b, f), t_val, dtype=torch.float32, device=self.device)
        flow, cache = dit_forward_inference(
            self.params, self.statics, self.rope_tables, x, t, xattn, cache,
            start, need_output=need_output)
        return flow, t

    @torch.inference_mode()
    def denoise_block(
        self,
        cache: KVCache,
        xattn: CrossAttnCache,
        noisy: torch.Tensor,                  # [B, f, H, W, C]
        current_start_frame,
        generator=None,
        renoise: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Denoise one block and persist its K/V. Returns (x0, cache).

        current_start_frame: an int, or one start a stream ([B] ints, the
        JAX package's per-slot starts for continuous batching).
        renoise: the noise added after each denoise step but the last,
        n_steps - 1 tensors shaped like `noisy` (a test hands in the noise
        the JAX package drew); when None it is drawn from `generator`: one
        torch.Generator, or a sequence of one per batch row (None for an
        idle row, which gets zeros). Under dp, noisy, the starts, renoise
        and the generators are the whole batch's; x0 is gathered, the cache
        holds the rank's rows.
        """
        steps = self.denoising_steps
        if renoise is not None and len(renoise) < len(steps) - 1:
            raise ValueError(f"renoise needs {len(steps) - 1} tensors, got {len(renoise)}")
        start = self._start_tokens(current_start_frame)
        with span("semi_ar.block", block=current_start_frame):
            x = self._local(noisy).to(self.device)
            for i, t_val in enumerate(steps):
                with span("dit.forward", step=i, need_output=True):
                    flow, t = self._forward(x, t_val, xattn, cache, start)
                x0 = self.schedule.flow_to_x0(flow, x, t)
                if i == len(steps) - 1:
                    break
                if renoise is not None:
                    fresh = self._local(renoise[i]).to(device=self.device, dtype=x0.dtype)
                else:
                    fresh = self._renoise(x0, generator)
                t_next = torch.full_like(t, steps[i + 1])
                x = self.schedule.add_noise(x0, fresh, t_next)
            if self.context_mode == "rerun":
                # the clean-context re-run: its K/V is what later blocks attend
                with span("dit.forward", step=-1, need_output=False):
                    self._forward(x0, self.context_noise, xattn, cache, start,
                                  need_output=False)
        return self._gather(x0), cache

    @torch.inference_mode()
    def cache_context_block(self, cache: KVCache, xattn: CrossAttnCache,
                            clean: torch.Tensor, current_start_frame) -> KVCache:
        """Write a block of clean latents into the KV cache without
        denoising (initial_latent prefixes)."""
        start = self._start_tokens(current_start_frame)
        with span("dit.forward", step=-1, need_output=False):
            self._forward(self._local(clean).to(self.device), self.context_noise, xattn,
                          cache, start, need_output=False)
        return cache

    @torch.inference_mode()
    def generate(
        self,
        noise: torch.Tensor,                  # [B, F, H, W, C]
        xattn: CrossAttnCache,
        generator: Optional[torch.Generator] = None,
        initial_latent: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        block_callback: Optional[Callable] = None,
        renoise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """Whole-clip generation. Returns (latents [B, F(+F_init), H, W, C],
        cache). renoise: one `denoise_block` renoise list per block."""
        fpb = self.cfg.model.num_frame_per_block
        num_frames = noise.shape[1]
        if num_frames % fpb:
            raise ValueError(
                f"num_frames {num_frames} must be divisible by block size {fpb}")
        if cache is None:
            cache = self.init_cache()
        outputs = []
        start_frame = 0
        if initial_latent is not None:
            ninit = initial_latent.shape[1]
            if ninit % fpb:
                raise ValueError(f"initial_latent frames {ninit} must be divisible by {fpb}")
            for i in range(ninit // fpb):
                cache = self.cache_context_block(
                    cache, xattn, initial_latent[:, i * fpb:(i + 1) * fpb],
                    start_frame)
                start_frame += fpb
            outputs.append(initial_latent.to(self.device))
        spec = self.statics.spec
        total = (start_frame + num_frames) * self.frame_seq
        if not spec.ring and total > spec.max_tokens:
            raise ValueError(
                f"clip needs {total} cache tokens but the global window holds "
                f"{spec.max_tokens}; raise max_attention_frames or enable the "
                "rolling window (local_attn_size)")
        for bi in range(num_frames // fpb):
            x0, cache = self.denoise_block(
                cache, xattn, noise[:, bi * fpb:(bi + 1) * fpb], start_frame,
                generator=generator,
                renoise=None if renoise is None else renoise[bi])
            outputs.append(x0)
            start_frame += fpb
            # a callback returning False stops generation at this block boundary
            if block_callback is not None and block_callback(x0, bi) is False:
                break
        return torch.cat(outputs, dim=1), cache
