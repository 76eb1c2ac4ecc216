"""MAGI-1 pipeline: chunk-windowed AR-diffusion generation (port of
`inferix_tpu/pipeline/magi.py`, its single-device branches).

Parity with the reference `MagiPipeline` + `SampleTransport.walk`
(`inferix/pipeline/magi/pipeline.py:32-114`, `video_generate.py:253-769`):
T2V / I2V / V2V through prefix chunks, the windowed denoise loop that yields
clean chunks as they finish (so that `MagiVideoPipeline` decodes each as it
comes), the fwd_extra_1st_chunk clean re-forward that persists a finished
chunk's KV, CFG dispatch (the 3-forward cond_pre+text / cond_pre / uncond
with per-t-range scales, `dit_model.py:399-536`; a 2-forward text CFG; or
the distilled single forward with its nearly-clean re-mix), and the
kv-range policies.

Every forward is the port's `models.magi.dit` (`magi_forward`,
`magi_forward_window_scan`, `magi_forward_uncond`, `sync_cache_rows`), so
on the card the attention runs through the flash kernels and W8A8 trees
through the int8 GEMM and act-quant kernels. The window cache is written in
place. Every random draw (the walk's noise) goes through `_draw_noise` from
an explicit `torch.Generator`.

The window cache takes the runtime's layouts (`kv_head_major`,
`kv_alloc_pad`), and a resume state carries the cache in the layout of the
run that saved it (a JAX head-major state too).

On a mesh (`parallel.mesh.make_mesh`, one process a rank, every rank
calling the pipeline with the same inputs) of sp or tp > 1 the walk runs
`cp_strategy` "cso" or "ulysses" (forced to "cso" when the runtime names
neither, as the JAX pipeline does): each rank holds its tp shard of the
tree (gated fc1 split into gate / up first) and its kv heads of the window
cache; the 3-CFG row sync stays on the rank (its cache rows are whole).
At pp > 1 every forward is a GPipe pipeline (`models.magi.dit.magi_forward_pp`):
the batch is 2 rows even at cfg_number 1 (the two halves are the
pipeline's microbatches, as in the JAX pipeline) and the rank holds its
stage's layers of the tree and of the cache. At dp > 1 each rank holds its
rows of the latents and the cache; the velocity rows that the CFG
combination reads are gathered over dp, and the 3-CFG row sync crosses
from dp rank 1 to dp rank 0. The prefix-free third forward runs whole on
every dp rank.
`MagiVideoPipeline(tile=True)` decodes each chunk through overlapping
tiles (`parallel/tile_parallel.py`), on `decode_devices` when given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kvcache.cache import KVCache, cache_shape, init_kv_cache
from ..parallel.distributed_attention import sp_comm_bytes_per_layer
from ..parallel.mesh import as_mesh, magi_param_shards
from ..parallel.pipeline_parallel import stage_layers
from ..parallel.tile_parallel import Replicas, TileProcessor
from ..models.magi.dit import (
    MagiModelConfig,
    Params,
    init_magi_params,
    magi_forward,
    magi_forward_uncond,
    magi_forward_window_scan,
    make_magi_statics,
    split_gated_fc1,
    sync_cache_rows,
)
from ..models.magi.scheduler import ChunkSchedule, MagiScheduleConfig
from ..ops.flash_attention import DEFAULT_KV_BLOCK
from ..profiling.profiler import InferixProfiler

WINDOW_DISPATCHES = ("per_chunk", "scan", "whole")


@dataclasses.dataclass
class MagiRuntimeConfig:
    """Runtime knobs (the reference 4.5B json's `runtime_config`). Every
    field of the JAX package's config is kept, so that each
    `examples/configs/magi_*.json` loads; the TPU-only ones say below what
    they do here."""

    cfg_number: int = 1                     # 1 = distilled, 3 = full CFG
    cfg_t_range: Sequence[float] = (0.0, 0.0217, 0.1, 0.3, 0.999)
    prev_chunk_scales: Sequence[float] = (1.5, 1.5, 1.5, 1.0, 1.0)
    text_scales: Sequence[float] = (7.5, 7.5, 7.5, 0.0, 0.0)
    num_steps: int = 8
    window_size: int = 4
    chunk_width: int = 6
    noise2clean_kvrange: Sequence[int] = ()
    clean_chunk_kvrange: int = -1
    clean_t: float = 0.9999
    seed: int = 1234
    t_schedule: str = "sd3"
    t_shift: float = 3.0
    # distilled checkpoints (reference engine_config.distill +
    # shortcut_mode): the condition vector gains a distill-dt embedding, and
    # when the oldest denoising chunk is nearly clean (t > threshold) its
    # velocity is re-mixed with a prefix-free re-forward of the same chunk
    # (forward_dispatcher distill_nearly_clean_chunk, dit_model.py:543-576)
    distill: bool = False
    shortcut_mode: str = ""
    distill_nearly_clean_chunk_threshold: float = 0.3
    distill_prev_chunks_scale: float = 0.7  # reference env prev_chunks_scale
    # in-forward context parallelism over a mesh of sp or tp > 1: "cso"
    # (per-chunk all-to-alls) or "ulysses" (one pair a window); "none" on
    # such a mesh is taken as "cso"
    cp_strategy: str = "none"
    # the int8 window cache with per-(token, head) scales (B2's path)
    quantize_kv: bool = False
    # the TPU's span-sized kernel grids: no effect here, the CUDA kernels
    # walk only each chunk's span
    span_grid: bool = True
    # the window cache's layouts: [L, B, Hkv, S, D] storage, and its slots
    # padded to a multiple of 2048 (never written or attended)
    kv_head_major: bool = False
    kv_alloc_pad: bool = False
    # the TPU's switch for the fused act-quant chain: no effect here, the
    # port always quantizes through the fused act-quant kernel
    fused_act_quant: bool = False
    # window dispatch: "per_chunk" (default) runs a window as one forward a
    # chunk chained through the cache (chunk i's kv range covers only chunks
    # <= i, which the earlier forwards wrote), at ~1/window the activations
    # of "whole" (one forward over the window); "scan" is the JAX package's
    # one-program form of the per-chunk loop, here
    # `magi_forward_window_scan`, the same loop. Under 3-CFG the rows' spans
    # are synced once after a per-chunk window.
    window_dispatch: str = "per_chunk"


class MagiPipeline:
    """The MAGI walk over one stream: `generate_chunks` yields each chunk's
    clean latents as it finishes.

    params: the MAGI DiT tree (`models.magi.dit`, bf16 / fp8 distill /
    W8A8), or None to draw one (`init_magi_params`) from `generator`
    (default: a generator on `device` seeded runtime.seed). dtype: the
    activations' and latents' dtype; kv_dtype the cache's storage dtype
    (torch.float8_e4m3fn: the e4m3 cache). The int8 cache is
    runtime.quantize_kv."""

    def __init__(
        self,
        model_cfg: MagiModelConfig = MagiModelConfig(),
        runtime: MagiRuntimeConfig = MagiRuntimeConfig(),
        params: Optional[Params] = None,
        latent_h: int = 32,
        latent_w: int = 32,
        max_chunks: int = 16,
        dtype: torch.dtype = torch.bfloat16,
        profiler: Optional[InferixProfiler] = None,
        mesh=None,
        kv_dtype: Optional[torch.dtype] = None,
        device: str | torch.device = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        mesh = as_mesh(mesh)
        sp_mode = runtime.cp_strategy
        if mesh is not None and (mesh.sp.size > 1 or mesh.tp.size > 1) \
                and sp_mode not in ("cso", "ulysses"):
            print("[magi] tp/sp>1 mesh without cp_strategy: forcing cp_strategy='cso' "
                  "(attention must run inside the islands)", flush=True)
            sp_mode = "cso"
        if runtime.window_dispatch not in WINDOW_DISPATCHES:
            raise ValueError(f"window_dispatch must be one of {WINDOW_DISPATCHES}, got "
                             f"{runtime.window_dispatch!r}")
        self.cfg = model_cfg
        self.rt = runtime
        self.dtype = dtype
        self.device = resolve_device(device)
        self.profiler = profiler or InferixProfiler()
        self.profiler.device = self.device
        # batch 2 = (conditional, unconditional) halves, reference x.chunk(2);
        # the distilled path (cfg_number 1) runs one conditional forward,
        # except under pp, where the two halves are the pipeline's microbatches
        pp_on = mesh is not None and mesh.pp.size > 1
        self.batch = 2 if (runtime.cfg_number >= 2 or pp_on) else 1
        # data parallel: `rows`, the batch rows this rank runs (None: all)
        self._dp = mesh.dp if mesh is not None and mesh.dp.size > 1 else None
        self.rows, local = None, self.batch
        if self._dp is not None:
            if self.batch % self._dp.size:
                raise ValueError(f"batch {self.batch} does not split over dp {self._dp.size}")
            local = self.batch // self._dp.size
            self.rows = slice(self._dp.rank * local, (self._dp.rank + 1) * local)
        self.statics = make_magi_statics(
            model_cfg, local, latent_h, latent_w, max_chunks, dtype,
            mesh=mesh, sp_mode=sp_mode, kv_dtype=kv_dtype, quantize_kv=runtime.quantize_kv,
            kv_head_major=runtime.kv_head_major,
            kv_alloc_multiple=DEFAULT_KV_BLOCK if runtime.kv_alloc_pad else 0)
        if params is None:
            g = generator or torch.Generator(device=self.device).manual_seed(runtime.seed)
            params = init_magi_params(model_cfg, g, self.device, dtype)
        self.mesh = self.statics.mesh
        if pp_on:
            if "blocks" not in params:
                raise ValueError("the pp path requires the uniform blocks layout")
            params = {**params, "blocks": stage_layers(params["blocks"], mesh,
                                                       model_cfg.num_layers)}
        # the JAX package's count of one layer's window exchange a forward
        self.sp_comm_bytes = 0
        if self.mesh is not None:
            if model_cfg.gated_linear_unit and self.mesh.tp.size > 1:
                params = split_gated_fc1(params, model_cfg.ffn_hidden_size)
            params = magi_param_shards(params, self.mesh)
            self.sp_comm_bytes = sp_comm_bytes_per_layer(
                "cso", self.mesh.sp.size, 1, self.batch,
                runtime.window_size * self.statics.geo.chunk_tokens,
                self.statics.spec.max_tokens, model_cfg.num_attention_heads,
                model_cfg.kv_channels, itemsize=torch.empty((), dtype=dtype).element_size())
        self.params = params

    # -- CFG ----------------------------------------------------------------

    def _cfg_scales(self, t_vals) -> Tuple[np.ndarray, np.ndarray]:
        """Per-chunk (prev_chunk_scale, text_scale) by searchsorted t-bucket
        (reference get_cfg_scale, dit_model.py:495-498)."""
        rng = np.asarray(self.rt.cfg_t_range, np.float64)
        idx = np.searchsorted(rng - 1e-7, np.asarray(t_vals, np.float64)) - 1
        assert idx.min() >= 0 and idx.max() < len(self.rt.prev_chunk_scales)
        prev = np.asarray(self.rt.prev_chunk_scales, np.float32)[idx]
        text = np.asarray(self.rt.text_scales, np.float32)[idx]
        return prev, text

    def _null_caption(self, cap_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(null caption [1, cap_len, cap_dim] float32, mask [1, cap_len]):
        the learned null_caption_embedding table with the reference's
        50-token uncond mask (video_generate.py:68-81)."""
        table = self.params["y_embedder"]["null_caption_embedding"]
        assert cap_len <= table.shape[0], (
            f"caption length {cap_len} exceeds null table {table.shape[0]}")
        null = table[None, :cap_len].float()
        mask = torch.zeros(1, cap_len, dtype=torch.float32, device=null.device)
        mask[:, :min(50, cap_len)] = 1.0
        return null, mask

    # -- generation ---------------------------------------------------------

    def _draw_noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        """The walk's initial noise, float32 on the device: the walk's one
        random draw."""
        return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                           device=self.device)

    def generate_chunks(
        self,
        caption_emb,                 # [1, cap_len, cap_dim]
        caption_mask,                # [1, cap_len]
        chunk_num: int,
        prefix_latents=None,         # [1, F0, H, W, C]
        generator: Optional[torch.Generator] = None,
        resume_state: Optional[dict] = None,
        state_callback: Optional[Callable[[dict, int], None]] = None,
    ) -> Generator[Tuple[int, torch.Tensor], None, None]:
        """Yields (chunk_index, clean latents [1, chunk_width, H, W, C]) as
        chunks finish denoising: the reference `walk()` generator.

        Mid-walk checkpoint / resume (`utils/state_checkpoint.py`): pass
        `state_callback(state_dict, step)` to get the state after each
        forward (x, the cache's fields, step, per-chunk denoise counts), and
        `resume_state` (such a state) to continue a walk bit for bit. The
        callback receives the walk's LIVE tensors, which the next forward
        overwrites in place: it must clone what it keeps (or save it with
        `save_generation_state`). A resumed walk writes into the resume
        state's cache tensors. generator: the noise draw's (default: one on
        the device seeded runtime.seed); on resume the state's x replaces
        the draw."""
        cfg, rt = self.cfg, self.rt
        geo = self.statics.geo
        dev = self.device
        cw = rt.chunk_width
        caption_emb = torch.as_tensor(caption_emb, device=dev)
        caption_mask = torch.as_tensor(caption_mask, device=dev)

        # The GQA cross-attention takes each row's popcount as its span
        # length, which is right only for PREFIX masks (valid tokens, then
        # padding): refuse any other mask here.
        m = caption_mask.cpu().numpy() > 0
        if not bool(np.all(m[:, 1:] <= m[:, :-1])):
            raise ValueError(
                "caption_mask must be a prefix mask (no interior zeros): "
                "the cross-attention uses its popcount as the span length")

        chunk_offset = 0
        if prefix_latents is not None:
            prefix_latents = torch.as_tensor(prefix_latents, device=dev)
            assert prefix_latents.shape[1] % cw == 0
            chunk_offset = prefix_latents.shape[1] // cw

        sched = ChunkSchedule(MagiScheduleConfig(
            chunk_num=chunk_num, chunk_width=cw, window_size=rt.window_size,
            num_steps=rt.num_steps, chunk_offset=chunk_offset,
            t_schedule=rt.t_schedule, t_shift=rt.t_shift,
            shortcut_mode=rt.shortcut_mode,
            noise2clean_kvrange=rt.noise2clean_kvrange,
            clean_chunk_kvrange=rt.clean_chunk_kvrange, clean_t=rt.clean_t))

        # all-chunk latents x, noise shared by the cond / uncond rows, the
        # prefix chunks filled with the prefix; materialised per row, since
        # the walk writes into it
        g = generator or torch.Generator(device=dev).manual_seed(rt.seed)
        noise = self._draw_noise(g, (1, chunk_num * cw, geo.latent_h, geo.latent_w,
                                     cfg.latent_channels)).to(self.dtype)
        x = noise.expand(self.statics.spec.batch, *noise.shape[1:]).clone()
        del noise
        if prefix_latents is not None:
            x[:, :chunk_offset * cw] = prefix_latents.to(x.dtype)

        if resume_state is None:
            cache = init_kv_cache(self.statics.spec, dev, num_kv_heads=self.statics.kv_heads)
        else:
            c = resume_state["cache"]
            cache = KVCache(*(torch.as_tensor(c[f], device=dev) if f in c else None
                              for f in KVCache._fields))
            spec = self.statics.spec
            shape = cache_shape(spec, num_kv_heads=self.statics.kv_heads)
            want = (shape, shape) + ((shape[:-1],) * 2 if spec.quantized else (None, None))
            got = tuple(None if f is None else tuple(f.shape) for f in cache)
            if got != want:
                raise ValueError(f"the resume state's cache fields are {got}; this "
                                 f"runtime's cache layout wants {want}")

        # prefix feature extraction at clean_t fills the cache (the
        # reference's extract_prefix_video_feature, :400-404, with the null
        # caption for clean chunks); the velocity is discarded, so the third
        # CFG forward is skipped. Skipped on resume: the state's cache holds
        # the prefix KV already.
        if chunk_offset > 0 and resume_state is None:
            for ci in range(chunk_offset):
                cache = self._forward_window(
                    x[:, ci * cw:(ci + 1) * cw], np.array([rt.clean_t]),
                    caption_emb, caption_mask, cache, slice_point=ci,
                    kv_ranges=np.array([[0, ci + 1]], np.int32),
                    chunk_is_clean=[True], skip_prev_cfg=True,
                    distill_interval=float(sched.interval[0]))[1]

        start_step = 0
        if resume_state is not None:
            x = torch.as_tensor(resume_state["x"], device=dev).to(self.dtype).clone()
            start_step = int(resume_state["step"])
            sched.chunk_denoise_count[:] = np.asarray(resume_state["chunk_denoise_count"])

        # the profiler's step and chunk times: the card's, from the steps'
        # spans, read once the walk ends (`InferixProfiler.resolve`)
        chunk_first = None
        for step in range(start_step, sched.total_forward_steps):
            with self.profiler.span("magi.step", step=step) as step_span:
                c_start, c_end, _, _ = sched.window(step)
                extra_clean = sched.fwd_extra_1st_chunk(step)
                w_start = c_start - 1 if extra_clean else c_start
                n_chunks = c_end - w_start

                t_vals = sched.timesteps(step)
                if extra_clean:
                    t_vals = np.concatenate([[rt.clean_t], t_vals])
                kv_ranges = sched.kv_ranges(step, include_clean=extra_clean)
                _, denoise_idx = sched.stage_of(step)
                velocity, cache = self._forward_window(
                    x[:, w_start * cw:c_end * cw], t_vals, caption_emb, caption_mask, cache,
                    slice_point=w_start, kv_ranges=kv_ranges,
                    chunk_is_clean=[extra_clean] + [False] * (n_chunks - 1),
                    distill_interval=float(sched.interval[denoise_idx]))

                # Euler step over the denoising chunks only
                if extra_clean:
                    velocity = velocity[:, cw:]
                n_den = c_end - c_start
                v = velocity.reshape(velocity.shape[0], n_den, cw, *velocity.shape[2:])
                d = torch.as_tensor(sched.integrate_deltas(step), dtype=v.dtype,
                                    device=dev).reshape(1, -1, 1, 1, 1, 1)
                x_den = x[:, c_start * cw:c_end * cw].reshape(v.shape)
                x[:, c_start * cw:c_end * cw] = (x_den + v * d).reshape(
                    x.shape[0], n_den * cw, *x.shape[2:]).to(x.dtype)
            self.profiler.record_step_spans(step, float(t_vals[-1]), n_den, step_span)
            chunk_first = chunk_first or step_span

            done = sched.mark_integrated(step)
            if done is not None:
                clean = x[:1, done * cw:(done + 1) * cw].clone()
                self.profiler.record_block_spans(done - chunk_offset, cw, chunk_first,
                                                 step_span)
                chunk_first = None
                yield done - chunk_offset, clean

            if state_callback is not None:
                # counts are taken AFTER mark_integrated, so a resume at
                # step + 1 continues with consistent completion accounting
                state_callback({
                    "x": x, "cache": {k: f for k, f in cache._asdict().items()
                                      if f is not None},
                    "step": step + 1,
                    "chunk_denoise_count": sched.chunk_denoise_count.copy(),
                }, step)
        self.profiler.resolve()

    def _distill_dt_factor(self, distill_interval: Optional[float]) -> Optional[float]:
        """Reference distill-dt (dit_model.py:175-185)."""
        rt = self.rt
        if not rt.distill:
            return None
        if rt.num_steps == 12:
            assert distill_interval is not None
            return 4.0 / float(distill_interval) * 2.0
        return rt.num_steps / 4.0 * 2.0

    def _forward_window(self, x_window, t_vals, caption_emb, caption_mask, cache,
                        slice_point, kv_ranges, chunk_is_clean: Optional[List[bool]] = None,
                        skip_prev_cfg: bool = False,
                        distill_interval: Optional[float] = None):
        """One (optionally CFG) window forward. Returns (velocity float32,
        cache).

        cfg_number 3 is the reference forward_3cfg + forward_dispatcher
        (`dit_model.py:399-536`): row 0 = cond_pre_and_text, row 1 =
        cond_pre (null caption, the adaln dropout token, the row whose KV
        persists), a third prefix-free forward a chunk, and the per-chunk
        3-term combination with searchsorted t-bucket scales. skip_prev_cfg
        skips the third forward where only the cache write is needed
        (prefix feature extraction discards the velocity)."""
        rt = self.rt
        dev = self.device
        geo = self.statics.geo
        cw, ct = geo.chunk_width, geo.chunk_tokens
        n_chunks = len(t_vals)
        if chunk_is_clean is None:
            chunk_is_clean = [False] * n_chunks
        n_clean0 = int(np.sum(chunk_is_clean))
        ddt = self._distill_dt_factor(distill_interval)
        slice_point = int(slice_point)
        kv_ranges = np.asarray(kv_ranges, np.int32)

        # the distilled nearly-clean-chunk trick (reference
        # forward_dispatcher cfg_number 1, dit_model.py:543-576): when the
        # oldest denoising chunk is nearly clean, a COPY of it is appended as
        # an extra chunk that attends only to itself, and the two velocities
        # mixed. The extra chunk takes the NEXT chunk slot (rope and cache
        # span); its cache write is overwritten when that chunk enters a
        # window.
        nearly_clean = False
        if rt.cfg_number == 1 and rt.distill and not skip_prev_cfg and n_chunks > n_clean0:
            t_first = float(np.asarray(t_vals)[n_clean0])
            fits = (slice_point + n_chunks + 1) * ct <= self.statics.spec.max_tokens
            nearly_clean = t_first > rt.distill_nearly_clean_chunk_threshold and fits
        if nearly_clean:
            first = slice(n_clean0 * cw, (n_clean0 + 1) * cw)
            x_window = torch.cat([x_window, x_window[:, first]], dim=1)
            t_vals = np.concatenate([np.asarray(t_vals, np.float64),
                                     [float(np.asarray(t_vals)[n_clean0])]])
            kv_ranges = np.concatenate(
                [kv_ranges, [[slice_point + n_chunks, slice_point + n_chunks + 1]]],
                axis=0).astype(np.int32)
            chunk_is_clean = list(chunk_is_clean) + [False]
            n_chunks += 1

        t = torch.as_tensor(np.asarray(t_vals, np.float32), device=dev)[None].expand(
            self.batch, n_chunks)
        cap_len = caption_emb.shape[1]
        null_cap, null_mask = self._null_caption(cap_len)

        # per-chunk captions [B, n_chunks, cap_len, dim]: the caption for a
        # denoising chunk, the null caption for a clean one; the uncond row
        # takes the null caption throughout
        caps = torch.stack([null_cap[0] if clean else caption_emb[0].float()
                            for clean in chunk_is_clean])[None]
        masks = torch.stack([null_mask[0] if clean else caption_mask[0].float()
                             for clean in chunk_is_clean])[None]
        if self.batch == 2:
            caps = torch.cat([caps, null_cap[:, None].expand(1, n_chunks, *null_cap.shape[1:])])
            masks = torch.cat([masks, null_mask[:, None].expand(1, n_chunks, cap_len)])
            dropout = torch.tensor([False, True], device=dev)
        else:
            dropout = torch.tensor([False], device=dev)
        caps = caps.to(self.dtype)
        if self.rows is not None:   # this dp rank's rows of the batch
            t, caps, masks, dropout = (a[self.rows] for a in (t, caps, masks, dropout))

        sync = rt.cfg_number >= 2
        if rt.window_dispatch in ("per_chunk", "scan") and n_chunks > 1:
            # both are the one per-chunk loop here ("scan" is its lax.scan form
            # in the JAX package)
            velocity, cache = magi_forward_window_scan(
                self.params, self.statics, None, x_window, t, caps, masks, cache,
                slice_point, kv_ranges, caption_dropout=dropout, distill_dt_factor=ddt)
        else:
            velocity, cache = magi_forward(
                self.params, self.statics, None, x_window, t, caps, masks, cache,
                slice_point, kv_ranges, distill_dt_factor=ddt, caption_dropout=dropout,
                sync_kv_rows=sync)
            sync = False
        if sync:
            # the per-chunk loop ran without the row sync, so that each later
            # chunk's cond+text row attended the earlier chunks' own row-0
            # K/V, as in the whole-window forward: sync the window once now
            sync_cache_rows(self.statics.spec, cache, slice_point * ct, n_chunks * ct,
                            dp=self._dp)
        if self._dp is not None:   # every row, for the CFG combination
            velocity = torch.cat(self._dp.all_gather(velocity), dim=0)

        if nearly_clean:
            s = rt.distill_prev_chunks_scale
            first = slice(n_clean0 * cw, (n_clean0 + 1) * cw)
            v_first = velocity[:, first].float()
            v_extra = velocity[:, (n_chunks - 1) * cw:].float()
            mixed = (s * v_first + (1.0 - s) * v_extra).to(velocity.dtype)
            velocity = torch.cat([velocity[:, :n_clean0 * cw], mixed,
                                  velocity[:, (n_clean0 + 1) * cw:(n_chunks - 1) * cw]], dim=1)
            n_chunks -= 1
            t_vals = t_vals[:-1]
            chunk_is_clean = chunk_is_clean[:-1]
        n_clean = int(np.sum(chunk_is_clean))
        if rt.cfg_number == 3 and not skip_prev_cfg:
            velocity = self._apply_3cfg(x_window, t_vals, velocity, null_cap, null_mask,
                                        chunk_is_clean, ddt)
        elif rt.cfg_number == 2 and not skip_prev_cfg and len(t_vals) > n_clean:
            # 2-forward text-only CFG (an extension of the JAX package: the
            # reference dispatcher has 1 and 3): per-chunk text scales on the
            # cond / uncond rows
            _, text_s = self._cfg_scales(np.asarray(t_vals)[n_clean:])
            v = velocity.reshape(velocity.shape[0], n_chunks, cw, *velocity.shape[2:])
            v_cond, v_unc = v[:1], v[1:]
            w = torch.cat([torch.zeros(n_clean, device=dev),
                           torch.as_tensor(text_s, device=dev)]).reshape(1, -1, 1, 1, 1, 1)
            comb = v_unc + (1.0 + w) * (v_cond - v_unc)
            velocity = comb.expand(v.shape).reshape(velocity.shape)
        if self.rows is not None:
            velocity = velocity[self.rows]
        return velocity, cache

    def _uncond_combine(self, x_den, t_den, caps, masks, v_text, v_pre, prev_s, text_s,
                        distill_dt_factor=None) -> torch.Tensor:
        """The third CFG forward (prefix-free, a chunk a row) and the 3-term
        per-chunk combination in float32 (dit_model.py:495-536). The
        distill-dt embedding, when configured, applies to every forward,
        this one included."""
        v_unc = magi_forward_uncond(self.params, self.statics, x_den, t_den, caps, masks,
                                    distill_dt_factor=distill_dt_factor)
        prev_s = torch.as_tensor(prev_s, device=self.device)
        text_s = torch.as_tensor(text_s, device=self.device)
        w_u = (1.0 - prev_s).reshape(-1, 1, 1, 1, 1)
        w_p = (prev_s - text_s).reshape(-1, 1, 1, 1, 1)
        w_t = text_s.reshape(-1, 1, 1, 1, 1)
        out = w_u * v_unc.float() + w_p * v_pre.float() + w_t * v_text.float()
        return out.to(v_unc.dtype)

    def _apply_3cfg(self, x_window, t_vals, velocity, null_cap, null_mask,
                    chunk_is_clean, distill_dt_factor=None) -> torch.Tensor:
        """The reference 3-CFG combination over the denoising chunks; the
        result is the same in both rows."""
        cw = self.statics.geo.chunk_width
        n_chunks = len(t_vals)
        n_clean = int(np.sum(chunk_is_clean))
        n_den = n_chunks - n_clean
        t_den = np.asarray(t_vals)[n_clean:]
        prev_s, text_s = self._cfg_scales(t_den)

        # per-chunk rows of the prefix-free forward
        x_den = x_window[0, n_clean * cw:].reshape(n_den, cw, *x_window.shape[2:])
        t_u = torch.as_tensor(np.asarray(t_den, np.float32), device=self.device).reshape(
            n_den, 1)
        caps_u = null_cap[:, None].expand(n_den, 1, *null_cap.shape[1:]).to(self.dtype)
        masks_u = null_mask[:, None].expand(n_den, 1, null_mask.shape[-1])

        def chunks_of(row):
            return row[n_clean * cw:].reshape(n_den, cw, *row.shape[1:])

        v_t, v_p = chunks_of(velocity[0]), chunks_of(velocity[1])
        if self.rt.window_dispatch in ("per_chunk", "scan") and n_den > 1:
            # the rows are independent: one at a time, for the per-chunk
            # dispatch's activation size
            comb = torch.cat([
                self._uncond_combine(x_den[i:i + 1], t_u[i:i + 1], caps_u[i:i + 1],
                                     masks_u[i:i + 1], v_t[i:i + 1], v_p[i:i + 1],
                                     prev_s[i:i + 1], text_s[i:i + 1], distill_dt_factor)
                for i in range(n_den)])
        else:
            comb = self._uncond_combine(x_den, t_u, caps_u, masks_u, v_t, v_p, prev_s,
                                        text_s, distill_dt_factor)
        comb = comb.reshape(1, n_den * cw, *comb.shape[2:])
        # the clean prefix part is dropped by the caller (velocity[:, cw:])
        out = torch.cat([velocity[:1, :n_clean * cw].to(comb.dtype), comb], dim=1)
        return out.expand(velocity.shape)


class MagiVideoPipeline(MagiPipeline):
    """The MAGI pipeline with a per-chunk decode (reference
    post_chunk_process, `pipeline/magi/video_process.py:348-388`): each
    clean chunk is decoded by the ViT-VAE as it is yielded, whole or
    through overlapping tiles (`tile=True`,
    `parallel/tile_parallel.TileProcessor`). decode_devices routes the tiles
    to those devices (the ViT-VAE keeps no state between chunks), and
    implies the tiled decode. Each decode device holds one copy of the
    VAE's parameters, made at its first tile and made again only when the
    VAE's params change identity."""

    def __init__(self, *args, vae=None, tile: bool = False, decode_devices=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.vae = vae
        self.decode_devices = list(decode_devices) if decode_devices else None
        self.tile = tile or self.decode_devices is not None
        self._replicas = None

    def decode_chunk(self, chunk: torch.Tensor) -> torch.Tensor:
        """One chunk's pixels [1, T, H, W, 3] in [-1, 1] on the pipeline's
        device: the tiles of the JAX pipeline (`magi.py:829-843`: the
        chunk's T, half its height and width but at least 4 latents,
        overlap 2), or the whole decode."""
        if not self.tile:
            return self.vae.decode(chunk)
        if self._replicas is None or self._replicas.model is not self.vae:
            self._replicas = Replicas(self.vae)
        cfg = self.vae.cfg
        tp = TileProcessor(fn=lambda z: self._replicas.on(z.device).decode(z),
                           scale_t=cfg.patch_length, scale_hw=cfg.patch_size,
                           devices=self.decode_devices)
        px = tp.process(chunk, tile_t=chunk.shape[1], tile_h=max(chunk.shape[2] // 2, 4),
                        tile_w=max(chunk.shape[3] // 2, 4), overlap_h=2, overlap_w=2)
        return torch.from_numpy(px).to(self.device, chunk.dtype)

    def generate_video(self, caption_emb, caption_mask, chunk_num: int,
                       prefix_latents=None, generator: Optional[torch.Generator] = None,
                       chunk_callback: Optional[Callable[[torch.Tensor, int], None]] = None
                       ) -> torch.Tensor:
        """Generate and decode chunk by chunk; returns pixels [1, T, H, W, 3]
        in [-1, 1]. chunk_callback(pixels, index) gets each decoded chunk."""
        assert self.vae is not None, "MagiVideoPipeline needs a vae"
        pixels = []
        for idx, chunk in self.generate_chunks(caption_emb, caption_mask, chunk_num,
                                               prefix_latents, generator):
            px = self.decode_chunk(chunk)
            pixels.append(px)
            if chunk_callback is not None:
                chunk_callback(px, idx)
        return torch.cat(pixels, dim=1)


def magi_config_from_json(path: str) -> Tuple[MagiModelConfig, MagiRuntimeConfig]:
    """(MagiModelConfig, MagiRuntimeConfig) from a JSON file shaped like
    `examples/configs/magi_4p5b.json` (the reference's
    `MagiConfig.from_json`). Keys starting with "_" are comments; an
    unknown key raises KeyError."""
    import json

    with open(path) as f:
        d = json.load(f)

    def build(klass, sub):
        fields = {f.name for f in dataclasses.fields(klass)}
        kwargs = {}
        for k, v in (sub or {}).items():
            if k.startswith("_"):
                continue
            if k not in fields:
                raise KeyError(f"unknown {klass.__name__} key {k!r}")
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        return klass(**kwargs)

    return build(MagiModelConfig, d.get("model")), build(MagiRuntimeConfig, d.get("runtime"))


def magi_text_embeddings(prompt: str, embedder=None, params=None, tokenizer=None,
                         model_max_length: int = 120, device: str | torch.device = "cuda"):
    """Prompt -> (caption_emb [1, L, 4096], caption_mask [1, L] int32)
    through the MAGI t5-v1_1-xxl tower with the training-stage caption
    cleaning (reference `get_txt_embeddings`,
    `pipeline/magi/prompt_process.py:184-212`). Pass a `MagiT5Embedder` or
    the pieces to build one."""
    from ..models.text.umt5 import MagiT5Embedder

    if embedder is None:
        embedder = MagiT5Embedder(params=params, tokenizer=tokenizer,
                                  model_max_length=model_max_length, device=device)
    return embedder.get_text_embeddings([prompt])
