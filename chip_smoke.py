#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--blocks N]

Phases, each timed on a line of its own:
  1. device   - require a CUDA card; print its name and power limit
                (nvidia-smi), the torch, CUDA and nvcc versions.
  2. build    - build every kernel library from `csrc/`, one nvcc per source,
                all started together (-Xptxas -v output above the build time).
  3. kernels  - the flash-attention kernel (bf16 K/V) against its plain
                PyTorch version on the card, at the main path's shapes, with
                the stated tolerance; its time (CUDA events, median of 10
                after warm-up) at the spans of blocks 0, 2 and 6 beside its
                bound and SDPA, and at the full cache beside the plain
                version's time.
  4. main     - Self-Forcing Wan2.1-T2V-1.3B semi-AR generation at full width
                and depth (random weights from a seed, random text features),
                bf16, context_mode "rerun", over N blocks of 3 latent frames
                (default 2) on a 21-frame cache; launch counts per block, the
                output and the cache checked; then one layer and one whole
                forward with the kernel against the same with plain attention.
  5. w8a8 kernels - the int8 GEMM, the act-quant and the LN+modulate+quant
                kernels, each against its plain version at every main-path
                shape of the W8A8 path and a few edge cases (the GEMM also
                at the persistent scheduler's edges: fewer tiles than SMs,
                133 tiles, M 9360; its tile plan against the Python
                helper's; the quantizers at each edge of their row classes
                and past them, M 1, ragged M, M 9360, the K/V writes at B=2
                and in the window, frames of 13 rows, and every bf16 absmax
                with every bf16 value that can take a nonzero code under
                it), each launcher refusing a class it was not built for,
                then timed as in phase 3 (the quantizers at M 4680 and
                9360, each time with its share of the bound's rate).
  6. w8a8 main - the same generation with W8A8 linears (int8 per-channel
                weights from the same seed, per-token int8 activations, the
                fused act-quant prologues): launch counts of all four kernels
                per block and at text encode, the output and the cache
                checked; one layer and one whole forward with every kernel
                against the same with every plain version; the W8A8 flow
                against the bf16 one, printed for information.
  7. kv kernels - the int8-KV and the e4m3-K/V instantiations of the flash
                kernel against their plain versions at the full-cache shape
                (kv_start > 0, [B] bounds, one key, an empty span, fixedm and
                runmax; phase 3's tolerance), each wrapper refusing a bad
                operand (for all three K/V kinds also K/V strides the tensor
                maps cannot take and an empty cache), then timed beside the
                bound and SDPA over a dequantized bf16 copy, also at spans
                4680, 14040 and 32760 (int8 at B=1 and B=2).
  8. int8_b2 / window / fp8 main - this slice's paths: W8A8 with the int8
                KV cache at B=2 (2 blocks); W8A8 with the int8 KV cache
                through a 12-frame rolling window with 1 sink frame,
                context_mode "last_step", 5 blocks, so the ring wraps; bf16
                weights with the e4m3 KV cache (2 blocks). Each: attention
                kernel launches per block (30 layers x forwards) and none of
                the other attention kernel, the K/V-write act-quant launches,
                latents and cache checked, seconds per block; the window's
                kernel bounds within its 18720 keys and the last block's wrap
                into the ring with the sink kept; one layer and one forward
                with the kernel against the plain path (dequantize, attend).
  9. vae kernels - the bf16 and W8A8 halo conv kernels against their plain
                versions at every conv class of the decode and of the encode
                (W8A8 bit-equal; the encoder's RGB input conv, Cin 3, through
                the wrappers' zero channel padding; Cin 24 padded to 32),
                and the W8A8 activation quantization kernel (codes and s_x
                bit-equal) at every W8A8 class; each timed beside its bound
                and plain version, the convs beside cuDNN (B7's conv kernel
                on its codes and the quantization each on its own, and the
                two through the wrapper), summed a decode chunk and an
                encode chunk; the tile plan's L2 -> SM bytes.
 10. vae decode - the fp8 path's 6 latent frames decoded in two 3-frame
                chunks by the Wan2.1 causal VAE (default config, random
                weights from a seed, bf16) with conv_impl "xla" (cuDNN),
                "halo" and "halo_w8a8": kernel launches per chunk (30 B6;
                33 B7 and 33 quantizations), pixels [1, 21, 480, 832, 3]
                finite in [-1, 1], halo against xla, every W8A8 conv
                against the float32 conv of its input.
 11. fp8w kernels - the fp8 (e4m3) weight-only GEMM against its plain version
                at every main-path shape of the fp8 path (M 4680 x the four
                (K, N) classes, M 512 text K/V) and edges (M 70 with K 8960,
                M 1, one scale for all, f32 out, 133 tiles, M 9360), within
                one bf16 ulp, and every e4m3 code widened exactly; the
                weight codes quantized on the card bit-equal to the CPU
                quantizer's; the wrapper refusing bad operands; per-layer
                time beside the bound, the plain version and cuBLAS bf16
                over a dequantized copy.
 12. fp8w main - N blocks with fp8 weights (`--quant fp8`: e4m3 per-channel
                block linears, bf16 KV, rerun): 900 fp8 GEMM and 150 flash
                launches a block, 60 fp8 GEMMs at text encode and no int8
                kernel; latents and cache checked; one layer and one forward
                with the kernel against the plain GEMM; the flow against
                bf16's, for information.
 13. quant-attention kernels - the int8-QK and int8-PV attention entry
                points (TPU kernels 3, 4; the wgmma kernel of
                `csrc/flash_attention_sm90.cu`) against their plain versions
                code by code at the full cache (B=1 and B=2 with [B]
                lengths, kv_len 30000, 1 and 0, with and without lse,
                kv_block 128 and 192, kv_block 64 over 4680 keys): a code
                may differ by 1 only at a rounding tie, the output is
                bounded through the differing codes; each wrapper refusing
                K/V the tensor maps cannot take; timed beside the bound and
                SDPA over a dequantized bf16 copy, also at spans 4680, 14040
                and 32760. No path calls them (0 launches).
 14. vae encode - 9 seeded pixel frames [1, 9, 480, 832, 3] in [-1, 1]
                encoded (chunks of 1, 4, 4 frames) to [1, 3, 60, 104, 16] by
                the bf16 VAE with conv_impl "xla", "halo" and "halo_w8a8":
                22 B6 launches a chunk (22 B7 and 22 quantizations), halo
                against xla, every W8A8 conv against the float32 conv of its
                input, seconds a chunk.
 15. pipeline   - this slice's path: SelfForcingPipeline on Wan2.1-T2V-1.3B
                at full width and depth (W8A8 linears, a seeded stand-in
                text encoder, the bf16 halo VAE): run_text_to_video AFTER_ALL
                over 21 frames (latents bit-equal to SemiARGenerator.generate
                on the same draws, video bit-equal to the VAE's decode,
                launches a block, 30 B6 a decode chunk, the profiler's
                blocks, stages and time to the first block);
                run_streaming_generation over 2 segments (9 frames, then 3
                carried + 6 new) with AUTO resolving to TRUE_STREAMING, the
                streamed pixels bit-equal to the decode of each segment's
                new latents, then DEFERRED_DECODE; run_interactive_generation
                (a prompt update before segment 1, stop() at its block 1);
                with the int8 KV cache run_image_to_video over 18 frames
                after the encode phase's 3-frame latent (150 B2 launches a
                block) and the KV manager (set_range / get_range against
                the plain versions, offload to pinned host and back, clear()
                freeing the cache's bytes). Seconds a block and the time to
                the first block beside the card's name and power limit.
 16. text encoders - WanTextEncoder at UMT5-XXL width and depth (bf16, the
                byte stand-in tokenizer, B=2 prompts of other lengths over 512
                tokens): padded rows exactly 0, the features against the
                float32 run on the same weights, stream_layers=True bit-equal
                to the resident run with both runs' peak device bytes;
                clip_vision_encode (ViT-H/14, 224^2 -> 257 x 1280) and
                xlm_roberta_clip_text (large) against their float32 runs;
                seconds of each encode.
 17. umt5 pipeline - phase 15's run_text_to_video (W8A8, 21 frames,
                AFTER_ALL) fed by that UMT5 encoder: latents bit-equal to
                SemiARGenerator.generate on the same features and draws,
                launches a block, the time to the first block.
 18. cfg        - CausalDiffusionPipeline, Wan2.1-T2V-1.3B bf16, B=1 (a
                2-row cache), positive and negative prompts through UMT5:
                UniPC with 20 steps over 2 blocks ((steps + 1) x 30 B1 a
                block), one forward at B=2 against plain attention, then
                DPM++ with 8 steps over 1 block at guidance 5 and 0 (the
                latents differ); seconds a block.
 19. causvid    - CausVidPipeline.run_rollouts, fp8 weight-only linears and
                the int8 KV cache, 2 rollouts of 9 frames with a 3-frame
                overlap, the bf16 halo VAE: B8 900 / B2 150 / B4 300 a block,
                B6 in every decode chunk and the boundary encode, segment 2
                starting from the re-encoded boundary frame, pixel shapes
                after the trim.
 20. continuous - ContinuousBatcher, W8A8 + int8 KV, 2 slots: streams
                admitted at steps 0 and 1, one retired after 3 blocks and
                another admitted into its slot at position 0; the 12-frame
                ring with 1 sink; each stream against itself alone at B=1
                with the same draws; B2 launches a step.
 21. i2v-14B    - Wan2.1-I2V-14B widths (dim 5120, 40 x 128 heads, ffn 13824,
                40 layers, in_dim 36), W8A8 drawn and quantized layer by
                layer, the bf16 21-frame cache: B3 / B4 / B5 / B1 (40 heads)
                against their plain versions at its shapes; the text and
                CLIP K/V (phase 16's features), 2 blocks of
                dit_forward_inference (4 denoise + 1 context forward) on
                36-channel inputs at 480x832, launches a block, peak device
                bytes; one layer and one forward against every plain version.
 22. files      - checkpoint files, written to a temporary directory by this
                script's own inverses of the converters: phase 4's seeded
                bf16 tree as a reference-format {"generator_ema": sd} .pt
                (~2.8 GB) through load_self_forcing_checkpoint (values
                bit-equal, dtypes by the JAX loader's policy);
                SelfForcingPipeline(model_path) under W8A8, 2 blocks, latents
                bit-equal to the pipeline given the in-memory conversion,
                phase 6's launches a block; the default VAEConfig VAE as a
                .pth through load_wan_vae (halo, bf16), its decode bit-equal,
                30 B6 a chunk; UMT5-XXL width cut to 2 layers (~2.9 GB bf16)
                in 3 HF safetensors shards (this script's own writer) through
                load_sharded_safetensors, convert_t5_encoder_state_dict and
                WanTextEncoder, the features bit-equal; seconds and GB/s of
                each write and load.
 23. wholeclip  - dit_forward_bidirectional (one call), _block_causal (7
                blocks of 3) and _teacher_forcing (7 noisy + 7 clean
                forwards) in bf16 over 21 latent frames (32760 tokens): B1 at
                32760 query rows over 32760 keys and the cross-attention call
                at 512 keys against the plain version (chunked over the query
                rows; ATTN_TOL), layer 0 against plain attention
                (LAYER_RTOL), the three properties (the last frame moves
                frame 0; blocks 0-5 bit-equal when block 6's input flips;
                teacher forcing's block 0 independent of clean), B1 launches
                a call (30 a forward, plus 30 where the cross-attention
                logits pass 256 MiB), seconds and peak device bytes.
 24. resume     - W8A8 with the int8 KV cache, 6 of 30 layers, a 6-frame
                rolling cache (9360 tokens): 2 blocks, save_generation_state
                (cache, torch.Generator, frames_done), load_generation_state,
                2 more blocks, bit-equal to the 4 blocks without the break;
                30 B2 a block; save and load seconds.
 25. cli        - `python -m inferix_tpu_torch.cli` in subprocesses:
                self-forcing with phase 22's checkpoint, --quant int8,
                --frames 6 (exit 0, frames [21, 480, 832, 3] uint8 equal to
                an in-process run_text_to_video on the same config and seed);
                stream --tiny --backend file --segments 2 and causvid --tiny
                --rollouts 2 on the card (exit 0, their frame counts); the
                wall time of each.
 26. magi kernels - the MAGI-1 shapes: B1 through the GQA fold (24 q heads
                over 8 kv heads, 12150 rows over spans of 12150 / 36450 /
                60750 keys; e4m3 K/V at 60750; the caption cross-attention
                of 4 chunk rows over 800 keys with per-row kv_len and a
                strided V; 48 over 8 heads, 21600 rows over 86400 keys), B2
                at 60750 and 86400, each against the fold over the plain
                version (ATTN_TOL), B3 bit-equal at every MAGI-4.5B and 24B
                linear, B4 exact at their inputs (gelu_exact over 12288,
                silu_mul over 2 x 16384); each timed beside its bound.
 27. magi-4.5B  - examples/configs/magi_4p5b.json at full width and depth
                (34 layers, width 3072, seeded bf16 weights), 720x720 (12150
                tokens a chunk): a ChunkSchedule walk of 4 chunks (window 4,
                noise2clean [5, 4, 3, 2], clean chunk range 1, 4 steps where
                the reference takes 64: 7 window forwards) with per-chunk
                dispatch over a bf16 cache of 4 chunks; the 4-chunk window
                also as one whole-window forward (MAGI_WINDOW_RTOL); the
                3-CFG batch (B=2, sync_kv_rows: the rows' spans bit-equal)
                and the uncond forward; launches against the code's count,
                seconds a window forward by size.
 28. magi-4.5B w8a8 - phase 27's tree to W8A8 (magi_quantize_params_int8):
                the walk over a bf16, an int8 (B2) and an e4m3 (B1 kind 1)
                window cache, each step against phase 27 (MAGI_W8A8_RTOL)
                and the quantized caches against the bf16 one
                (MAGI_KV_RTOL), launches against the code's count; then the
                fp8 distill layout at full width, 3 layers, written as a
                reference-format .pt and converted (convert_magi_state_dict),
                its plain e4m3 forward against its magi_distill_quant_to_int8
                W8A8 forward with distill_dt_factor (MAGI_FP8_RTOL).
 29. magi-24B   - examples/configs/magi_24b.json's widths (6144, 48 q heads
                over 8, SwiGLU ffn 16384, half-channel VAE, x_rescale 0.1),
                4 of 48 layers, W8A8 + the int8 cache, 720x1280 (21600
                tokens a chunk): a 2-chunk window forward with fc1
                concatenated and split (bit-equal), seconds, peak device
                bytes and the full depth's bytes worked out.
 30. vitvae     - the MAGI ViT-VAE at full width (768 wide, 12 blocks, 16
                heads of 48, patch 4x8x8, z 16; seeded float32 weights, bf16
                compute): a 6-latent-frame chunk decoded at 90x90 (48601
                tokens) to [1, 24, 720, 720, 3]; its attention (SDPA pinned
                to the flash backend, never the [S, S] logits) against the
                plain float32 version on two slices of query rows (ATTN_TOL),
                refusing a head dim the backend cannot take; its first block
                in bf16 against float32 (VIT_BLOCK_RTOL); the rope tables and
                the pos-embed resize against the CPU path; a 1-frame image and
                a 24-frame prefix encoded at 720x720; a 24B chunk decoded at
                90x160 (86401 tokens); seconds and peak device bytes of each.
                The phase's encodes and decodes run in bf16; the I2V prefix
                of phase 31 is encoded from float32 frames, in float32, as
                the JAX package does.
 31. magi-4.5B pipeline - MagiVideoPipeline on magi_4p5b.json at full width
                and depth (phase 27's tree, bf16), 3-CFG, 720x720, 4 chunks,
                4 steps where the json takes 64, per-chunk dispatch, the
                caption from MagiT5Embedder (t5-v1_1-xxl width, 2 of 24
                layers, the byte stand-in tokenizer; bit-equal to umt5_encode),
                each chunk decoded by phase 30's VAE: B1 launches against the
                code's count (68 a chunk forward at B=2, 68 an uncond
                forward), the rows' spans synced after each window, the
                chunks bit-equal to a hand walk of the model's calls; a resume
                after window 3 bit-equal; "scan" bit-equal to "per_chunk" on a
                2-chunk window; an I2V run from a seeded 720x720 image (the
                prefix-extraction forward counted); seconds a window, a
                decode chunk and to the first chunk.
 32. magi-4.5B distill-quant - magi_4p5b_distill_quant.json (cfg 1, distill,
                the int8 window cache): phase 27's tree in the fp8 distill
                layout, requantized to W8A8 (magi_distill_quant_to_int8), a
                4-chunk walk of 8 steps (4 never pass the re-mix threshold):
                B1 / B2 / B3 / B4 launches against the code's count with the
                nearly-clean re-mix's extra chunks; each window's velocity
                against the same walk in bf16 (MAGI_W8A8_RTOL).
 33. magi-24B pipeline - MagiVideoPipeline on magi_24b.json's widths at 4 of
                48 layers: W8A8, the int8 cache, 3-CFG, 720x1280, 2 chunks,
                the 16-channel latents decoded by phase 30's VAE: finite
                pixels, the rows synced, peak device bytes beside phase 29's
                full depth.
 34. magi cli   - `python -m inferix_tpu_torch.cli magi` in a subprocess from
                files the phase writes (magi_4p5b.json cut to 2 layers, a
                seeded .pt, phase 30's VAE as config.json + safetensors), 2
                chunks: exit 0, frames [48, 720, 720, 3] equal to the same run
                in process.
 35. eval       - the evaluation path over the port's own clips, after phase
                25: the self-forcing command again from phase 22's checkpoint
                with --quant none and --quant fp8 (exit 0, frames [21, 480,
                832, 3] uint8); `vde` of phase 25's W8A8 clip (--chunks 7)
                equal to the in-process evaluate_video, every value finite;
                `vde --compare` of the W8A8 and the fp8 clip against the
                bf16 one equal to the in-process quality_delta (the deltas
                printed, not gated: the weights are seeded); RAFTDynamicDegree
                and AMTMotionSmoothness from seeded weight files in the
                official layouts on the card (their default device) against
                the same classes on the CPU over all 21 frames at 480x832,
                float32 with TF32 off (RAFT_RTOL on each pair's score, the
                moving fraction equal unless a pair is that near the
                threshold, AMT_CODE_TOL on the interpolated codes), the TF32
                gap printed, seconds and peak device bytes of each; the
                native frame pipe built by g++ (21 frames into a ring of 8:
                13 dropped, FIFO bit-equal), rgb_to_i420 bit-equal and
                laplacian_var within LAPLACIAN_RTOL of their numpy
                references, timed.
(Phase 13 runs after phase 7, phases 11-12 after phase 6, phases 30-32 after
phase 27, phase 35 after phase 25.)
The second-to-last line is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}. Any failure raises: the script exits
non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import inferix_tpu_torch.models.magi.vae as vitvae_mod
import inferix_tpu_torch.models.wan.vae as vae_mod
import inferix_tpu_torch.ops.attention as attention_mod
import inferix_tpu_torch.quant.api as quant_api
from inferix_tpu_torch import _build
from inferix_tpu_torch import native as native_mod
from inferix_tpu_torch.core.config import EngineConfig
from inferix_tpu_torch.core.interactive import InteractiveSession
from inferix_tpu_torch.core.media.streaming_backend import latents_to_uint8
from inferix_tpu_torch.core.memory import tree_map
from inferix_tpu_torch.core.types import DecodeMode, StreamingMode
from inferix_tpu_torch.eval.amt import AMTS, smoothness_score
from inferix_tpu_torch.eval.flow_metrics import register_flow_metrics
from inferix_tpu_torch.eval.raft import RAFT
from inferix_tpu_torch.eval.vbench_real import AMTMotionSmoothness, RAFTDynamicDegree
from inferix_tpu_torch.eval.vde import evaluate_video, quality_delta
from inferix_tpu_torch.kvcache.manager import KVCacheRequest
from inferix_tpu_torch.models.text.clip_vision import (
    CLIPVisionConfig, clip_vision_encode, init_clip_vision_params)
from inferix_tpu_torch.models.text import umt5 as umt5_mod
from inferix_tpu_torch.models.text.umt5 import (
    MagiT5Embedder, UMT5Config, WanTextEncoder, convert_t5_encoder_state_dict, init_umt5_params,
    t5_v1_1_xxl_config, text_preprocessing, umt5_encode)
from inferix_tpu_torch.models.text.xlm_roberta import (
    XLMRobertaConfig, init_xlm_roberta_params, xlm_roberta_clip_text)
from inferix_tpu_torch.models.wan.causal_dit import (
    DiTGeometry, dit_forward_bidirectional, dit_forward_block_causal, dit_forward_inference,
    dit_forward_teacher_forcing, fuse_qkv_params, layer_params, block_forward, patch_embed,
    precompute_crossattn_cache, time_embeddings)
from inferix_tpu_torch.kvcache.cache import (FP8_MAX, KVCache, KVCacheSpec, init_kv_cache,
                                             quantize_kv_block, valid_mask)
from inferix_tpu_torch.models.magi.dit import (
    MagiModelConfig, init_magi_params, magi_forward, magi_forward_uncond,
    magi_forward_window_scan, make_magi_statics, split_gated_fc1, sync_cache_rows)
from inferix_tpu_torch.models.magi.scheduler import ChunkSchedule, MagiScheduleConfig
from inferix_tpu_torch.models.magi.vae import (ViTVAE, ViTVAEConfig, init_vitvae_params,
                                               vitvae_rope_tables)
from inferix_tpu_torch.models.wan.vae import CausalVAE, VAEConfig
from inferix_tpu_torch.ops.act_quant import (
    adaln_quantize_rows_int8, adaln_quantize_rows_int8_reference,
    ln_quantize_rows_int8, ln_quantize_rows_int8_reference, quantize_rows_int8,
    quantize_rows_int8_reference, row_plan)
from inferix_tpu_torch.ops.flash_attention import (
    FP8, LOG2E, quant_ext_reference, flash_attention_gqa, flash_attention_gqa_quant,
    flash_attention_prefix, gqa_fold, gqa_unfold,
    flash_attention_prefix_quant, flash_attention_prefix_quant_i8,
    flash_attention_prefix_quant_reference, flash_attention_prefix_quant_v2,
    flash_attention_prefix_reference, pv_operand, quant_ext_kernel, quant_operands)
from inferix_tpu_torch.ops import halo_conv as halo_mod
from inferix_tpu_torch.ops.halo_conv import (
    _quantize_conv_act, halo_conv3d, halo_conv3d_reference, halo_conv3d_w8a8,
    halo_conv3d_w8a8_reference, pack_weight, quantize_conv_act, tile_plan)
from inferix_tpu_torch.ops.rope import build_rope_tables, rope_angles
from inferix_tpu_torch.pipeline.causvid import CausVidPipeline, causvid_config
from inferix_tpu_torch.pipeline.continuous import ContinuousBatcher
from inferix_tpu_torch.pipeline.magi import MagiPipeline, MagiVideoPipeline, magi_config_from_json
from inferix_tpu_torch.pipeline.magi_media import encode_prefix_latents, process_image
from inferix_tpu_torch.pipeline.self_forcing import SelfForcingPipeline
from inferix_tpu_torch.pipeline.self_forcing_cfg import CausalDiffusionPipeline
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.profiling.profiler import InferixProfiler, ProfilingConfig
from inferix_tpu_torch.quant.api import (magi_distill_quant_to_int8, magi_quantize_params_int8,
                                         memory_bytes, quantize_params, to_kernel_layout)
from inferix_tpu_torch.quant.kernels import (
    GEMM_LIBRARY, fp8_matmul, fp8_matmul_reference, gemm_plan, int8_matmul,
    int8_matmul_reference, quantize_act_int8_per_token, quantize_weight_fp8,
    quantize_weight_int8)
from inferix_tpu_torch.utils.checkpoint import (
    convert_causal_wan_state_dict, convert_magi_state_dict, convert_wan_vae_state_dict,
    load_magi_vae, load_self_forcing_checkpoint, load_sharded_safetensors, load_torch_state_dict,
    load_wan_vae)
from inferix_tpu_torch.utils.params import init_block_params, init_params, init_vae_params
from inferix_tpu_torch.utils.state_checkpoint import (load_generation_state,
                                                      save_generation_state)

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
LIBRARIES = ("flash_attention_sm90", "gemm_sm90", "act_quant", "halo_conv")

# Kernel vs its plain version, both in bf16 on the card. The two compute the
# same fp32 logits and p in other summation orders and with other exp2
# implementations (fp32 differences ~1e-6 relative), and both round p and the
# output to bf16. An fp32 result next to a bf16 rounding boundary can round
# the other way, and a p that does so shifts a short span's output by up to
# 2^-8 relative: the outputs may differ by up to 2 bf16 ulps, which is at most
# 2^-6 |out|. Per element, with rms the root mean square of the plain output
# over each batch row (each row has its own span):
#     |out_kernel - out_plain| <= ATTN_TOL * (|out_plain| + rms)
# The rms term covers outputs near 0 (sums of larger p*v terms over a long
# span) and keeps the bound at the scale of what is compared: at the full
# cache rms ~ 0.009, so an error of a few percent of a typical output fails.
ATTN_TOL = 2.0 ** -6
LSE_ATOL = 1e-3         # max |lse_kernel - lse_plain|, fp32 sums of ~1e4 terms
# One layer / one forward with the kernel against the same with plain
# attention: the attention difference above, carried through bf16 layers.
LAYER_RTOL = 2e-2       # ||update_kernel - update_plain|| / ||update_plain||
FORWARD_RTOL = 5e-2     # ||flow_kernel - flow_plain|| / ||flow_plain||

SQ, H, D, SKV = 4680, 12, 128, 32760  # one 3-frame block over a 21-frame cache
SPANS = (SQ, 3 * SQ, SKV)  # the live spans of blocks 0, 2 and 6 of a clip
SLEEP_CYCLES = 4_000_000  # ~2 ms of device clock ahead of each timed call

# W8A8 kernels against their plain versions, bf16 activations on the card.
# The int8 GEMM sums integers exactly and both versions apply the same _rn
# epilogue: bit-equal. The act-quant kernel repeats the plain arithmetic
# exactly with every act: its gelu, erf and sigmoid are the f32 expressions
# of the plain version, op for op, with the CUDA math library's tanhf and
# expf, which torch's CUDA tanh, exp and sigmoid call too: equal codes and
# scales (0 differing codes with every act on an H100). The LayerNorm
# kernel takes its f32 sums in other orders than the plain version, so a
# value at a rounding boundary of the bf16 rounding or of the code may round
# the other way: codes within 1, scales within one bf16 ulp (2^-7 relative) of the
# row's absmax, and rounding events in at most FLIP_SHARE of the codes. An
# event is a code that differs in a row whose scale agrees, or a row whose
# scale moved: its absmax element rounded to the neighbouring bf16 value,
# which rescales the whole row and flips ~200 of its 1536 codes at once
# (seen once, in 6240 LN+modulate rows). A rounding point moved or dropped
# in the kernel (the modulate's two ops contracted into one FMA, a missing
# bf16 rounding) shifts values by a bf16 ulp in a large share of the
# elements and flips codes by 1 in about 1e-2 of them; the boundary cases of
# the summation order flip about 1e-6 (H100 SXM).
CODE_TOL = 1
SCALE_RTOL = 2.0 ** -7
FLIP_SHARE = 1e-5
# One layer / one forward with every W8A8 kernel against every plain version
# (flash attention as above, and the prologue code flips carried through).
W8A8_LAYER_RTOL = 2e-2
W8A8_FORWARD_RTOL = 5e-2
DIM, FFN, TEXT = 1536, 8960, 512
# (name, M, K, N, calls a layer): the six linears of one W8A8 layer at M = one
# block's tokens; the text K/V projections run once a prompt at M = 512
LAYER_GEMMS = (("qkv", SQ, DIM, 3 * DIM, 1), ("o/cross_q/cross_o", SQ, DIM, DIM, 3),
               ("fc1", SQ, DIM, FFN, 1), ("fc2", SQ, FFN, DIM, 1))
# The persistent GEMMs' scheduler edges, both kernels: fewer tiles than SMs
# (M 1 and 70 at N 1536), the W8A8 + int8 KV path's M at B=2, and 133 tiles
# of 128 x 128 (one more than the SMs: a second round of one tile; see
# sched_gemms).
SCHED_GEMMS = (("m70", 70, DIM, DIM), ("m9360_o", 2 * SQ, DIM, DIM),
               ("m9360_fc1", 2 * SQ, DIM, FFN))


def sched_gemms(kernel: str) -> list:
    """SCHED_GEMMS and the 133-tile case of `kernel`: 133 row tiles by one
    column tile, tokens or channels by its plan's orientation."""
    m, n = next((m, n) for m, n in ((133 * 128, 128), (128, 133 * 128))
                if gemm_plan(m, n, kernel)[:2] == (128, 133))
    return [*SCHED_GEMMS, ("tiles133", m, DIM, n)]


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls.
    Each timed call is queued behind a device-side sleep of ~2 ms, so the
    host has enqueued the start event, fn's kernels and the end event before
    the device reaches them: the interval is the device time of fn's
    kernels, not the host's launch overhead (Python checks, ctypes), which
    is larger than the device time of a small kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(b: int, sq: int, span: int, lse: bool = False):
    """(bound_ms, bound_by) of prefix attention over `span` live keys."""
    flops = 4.0 * b * H * sq * span * D
    nbytes = 2.0 * b * H * D * (2 * sq + 2 * span) + (4.0 * b * H * sq if lse else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def device_phase(dev: torch.device) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc: {nvcc}", flush=True)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    return smi


def span_times(kern, label, q, k, v, batches, k_scale=None, v_scale=None):
    """The kernel at the spans of a clip's blocks 0, 2 and 6, for each batch
    size, beside its bound and SDPA over a bf16 (dequantized) copy of the
    same span. kern(q, k, v, [k_scale, v_scale,] span); timing launches are
    taken off the counts."""
    before = all_counts()
    for b in batches:
        for span in SPANS:
            extra = (k_scale[:b], v_scale[:b]) if k_scale is not None else ()
            t = time_ms(lambda: kern(q[:b], k[:b], v[:b], *extra, span))
            if k_scale is not None:
                kd, vd = (dequantize(c[:b, :span], sc[:b, :span])
                          for c, sc in ((k, k_scale), (v, v_scale)))
            else:
                kd, vd = (c[:b, :span].to(torch.bfloat16) for c in (k, v))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q[:b], kd, vd))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            del kd, vd, qt, kt, vt
            bnd, by = attention_bound(b, SQ, span)
            print(f"{label} B={b} span {span}: {t:.4f} ms, sdpa {lib:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by}), {4 * b * SQ * span * H * D / t / 1e9:.1f} "
                  f"TFLOP/s", flush=True)
    restore_counts(before)


def kernel_phase(dev: torch.device) -> dict:
    """Kernel vs plain version over the main path's shapes and bounds."""
    g = torch.Generator(device=dev).manual_seed(1)
    q2 = torch.randn(2, SQ, H, D, generator=g, device=dev).to(torch.bfloat16)
    k2 = torch.randn(2, SKV, H, D, generator=g, device=dev).to(torch.bfloat16)
    v2 = torch.randn(2, SKV, H, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = q2[:1], k2[:1], v2[:1]
    cases = [  # (name, q, k, v, kv_start, kv_len, softmax)
        ("len1", q, k, v, 0, 1, "fixedm"),
        ("empty", q, k, v, 4680, 4680, "fixedm"),
        ("len4680", q, k, v, 0, 4680, "fixedm"),
        ("len14040", q, k, v, 0, 14040, "fixedm"),
        ("len32760", q, k, v, 0, 32760, "fixedm"),
        ("len32760_runmax", q, k, v, 0, 32760, "runmax"),
        ("start1000_len14040", q, k, v, 1000, 14040, "fixedm"),
        ("start1000_len14040_runmax", q, k, v, 1000, 14040, "runmax"),
        ("b2_rows", q2, k2, v2, torch.tensor([0, 1000], device=dev),
         torch.tensor([9360, 32760], device=dev), "fixedm"),
        ("b2_rows_runmax", q2, k2, v2, torch.tensor([0, 1000], device=dev),
         torch.tensor([9360, 32760], device=dev), "runmax"),
    ]
    worst, failed = 0.0, []
    for name, qq, kk, vv, start, end, sm in cases:
        out, lse = flash_attention_prefix(qq, kk, vv, end, start, softmax=sm,
                                          return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_prefix_reference(
            qq, kk, vv, end, start, softmax=sm, return_lse=True)
        ref = ref.float()
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        rms = ref.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
        bound = ATTN_TOL * (ref.abs() + rms)
        # an empty span gives ref = 0 and bound 0: the kernel must give 0
        share = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                            torch.where(diff > 0, float("inf"), 0.0)).max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        lse_err = (lse - ref_lse).abs().max().item()
        ok = share <= 1 and lse_err <= LSE_ATOL and torch.isfinite(out).all().item()
        print(f"kernel case {name}: max_abs {err:.3e} max_rel {rel:.3e} rms(ref) "
              f"{', '.join(f'{x:.3e}' for x in rms.flatten().tolist())} "
              f"max |diff|/({ATTN_TOL:g}*(|ref|+rms)) {share:.3f} (tol 1) "
              f"lse_max_abs {lse_err:.3e} (tol {LSE_ATOL:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(name)
        worst = max(worst, err)
    if failed:
        raise AssertionError(f"kernel cases {failed} disagree with the plain version")

    span_times(flash_attention_prefix, "kernel time", q2, k2, v2, (1,))
    # the steady-state shape of the main path: a block over the full cache
    ms = time_ms(lambda: flash_attention_prefix(q, k, v, SKV))
    plain_ms = time_ms(lambda: flash_attention_prefix_reference(q, k, v, SKV))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    bound_ms, bound_by = attention_bound(1, SQ, SKV)
    print(f"kernel full cache: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return {"name": "flash_attention_prefix", "route": "cuda",
            "source": "inferix_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": "inferix_tpu/ops/flash_attention.py:53",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def plain_flash_attention(q, k, v, kv_mask=None, scale=None):
    """The mask wrapper with the plain version in place of the kernel."""
    kv_len = k.shape[1] if kv_mask is None else kv_mask.sum(-1, dtype=torch.int32)
    return flash_attention_prefix_reference(q, k, v, kv_len, scale=scale)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main_path_config(blocks: int, w8a8: bool = False) -> EngineConfig:
    """Wan2.1-T2V-1.3B, 480x832, bf16, rerun, over `blocks` 3-frame blocks;
    w8a8: the JAX package's headline serving recipe (`bench.py:229-234`,
    int8 per-channel linears, bf16 KV cache) with the fused act-quant."""
    cfg = EngineConfig()
    cfg.runtime.num_frames = cfg.model.num_frame_per_block * blocks
    if w8a8:
        q = cfg.quant
        q.enabled, q.dtype, q.granularity = True, "int8", "per_channel"
        q.quantize_kv_cache = False
    return cfg


def main_path_setup(dev: torch.device, cfg: EngineConfig):
    """Random weights, text K/V and initial noise from seed 0 (the same
    weights for bf16 and W8A8: a W8A8 config quantizes them). Returns
    (SemiARGenerator, text K/V, noise [1, F, H, W, C], torch.Generator)."""
    m, r = cfg.model, cfg.runtime
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(m, g, device=dev, dtype=torch.bfloat16)
    if cfg.quant.enabled:
        params = quantize_params(params, cfg.quant)
    gen = SemiARGenerator(cfg, params, dtype=torch.bfloat16, device=dev)
    context = torch.randn(1, m.text_len, m.text_dim, generator=g,
                          device=dev).to(torch.bfloat16)
    xattn = gen.encode_text_context(context)
    noise = torch.randn(1, r.num_frames, r.latent_height, r.latent_width,
                        r.latent_channels, generator=g, device=dev).to(torch.bfloat16)
    return gen, xattn, noise, g


def main_path_phase(dev: torch.device, cfg: EngineConfig) -> int:
    """Generate cfg.runtime.num_frames frames; returns the kernel launches."""
    t0 = time.perf_counter()
    m, r = cfg.model, cfg.runtime
    fpb = m.num_frame_per_block
    blocks = r.num_frames // fpb
    gen, xattn, noise, g = main_path_setup(dev, cfg)
    torch.cuda.synchronize()
    print(f"main path setup (weights, text K/V): {time.perf_counter() - t0:.3f} s",
          flush=True)

    per_block = []
    marks = [time.perf_counter()]

    def on_block(x0, bi):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_block.append(flash_attention_prefix.launches)
        print(f"block {bi}: {marks[-1] - marks[-2]:.3f} s, launches "
              f"{per_block[-1] - (per_block[-2] if bi else 0)}", flush=True)

    flash_attention_prefix.launches = 0
    latents, cache = gen.generate(noise, xattn, generator=g, block_callback=on_block)
    torch.cuda.synchronize()
    launches = flash_attention_prefix.launches

    forwards = len(gen.denoising_steps) + 1  # rerun: steps + context re-run
    want = [m.num_layers * forwards * (i + 1) for i in range(blocks)]
    if per_block != want:
        raise AssertionError(f"kernel launches per block {per_block}, want {want}")
    shape = (1, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError(f"latents {tuple(latents.shape)} (want {shape}) "
                             "or not finite")
    end = r.num_frames * gen.frame_seq
    for buf in (cache.k, cache.v):
        if not (buf[:, :, :end].abs().amax(dim=(-1, -2)) > 0).all():
            raise AssertionError("a written cache slot is zero")
        if buf[:, :, end:].any():
            raise AssertionError("a cache slot past the span was written")
    print(f"main path: latents {tuple(latents.shape)} finite, |x0| max "
          f"{latents.float().abs().max().item():.3f}, launches {launches}, cache "
          f"slots [0, {end}) written in all {m.num_layers} layers, rest zero",
          flush=True)

    # one layer, then one whole forward, kernel vs plain attention, for the
    # last block at its first denoise step over the cache as generated
    f0 = r.num_frames - fpb
    start = f0 * gen.frame_seq
    geo, spec = gen.statics.geo, gen.statics.spec
    x_blk = latents[:, f0:]
    t = torch.full((1, fpb), gen.denoising_steps[0], device=dev)
    with torch.inference_mode():
        tokens = patch_embed(gen.params, m, x_blk)
        _, e0 = time_embeddings(gen.params, m, t)
        angles = rope_angles(gen.rope_tables, fpb, geo.grid_h, geo.grid_w, f0)
        mask = valid_mask(spec, start + geo.tokens, device=dev)
        blk = layer_params(gen.params["blocks"], 0)
        outs = []
        for plain in (False, True):
            lc = (cache.k[0].clone(), cache.v[0].clone())
            with mock.patch.object(attention_mod, "flash_attention",
                                   plain_flash_attention if plain
                                   else attention_mod.flash_attention):
                y, lc = block_forward(blk, m, spec, tokens, e0, angles, lc,
                                      xattn.k[0], xattn.v[0], start, mask)
            outs.append((y, lc))
        layer_err = rel_err(outs[0][0] - tokens, outs[1][0] - tokens)
        kv_err = max(rel_err(outs[0][1][i], outs[1][1][i]) for i in (0, 1))
        flows = []
        for plain in (False, True):
            with mock.patch.object(attention_mod, "flash_attention",
                                   plain_flash_attention if plain
                                   else attention_mod.flash_attention):
                flow, _ = dit_forward_inference(gen.params, gen.statics,
                                                gen.rope_tables, x_blk, t, xattn,
                                                cache, start)
            flows.append(flow)
        fwd_err = rel_err(flows[0], flows[1])
    print(f"block_forward kernel vs plain: update rel err {layer_err:.3e} "
          f"(tol {LAYER_RTOL:g}), written K/V rel err {kv_err:.3e}", flush=True)
    print(f"dit_forward_inference kernel vs plain: flow rel err {fwd_err:.3e} "
          f"(tol {FORWARD_RTOL:g})", flush=True)
    if not (layer_err <= LAYER_RTOL and kv_err == 0 and fwd_err <= FORWARD_RTOL):
        raise AssertionError("the main path with the kernel disagrees with plain attention")
    phase("main", t0)
    return launches


def gemm_times(m: int, k: int, n: int, out_bytes: int = 2):
    """(ops_ms, bytes_ms) of the int8 GEMM with its epilogue and bias: its
    operations at the int8 peak, its bytes (each operand read once, the
    output written once) at the memory rate."""
    nbytes = m * k + n * k + m * n * out_bytes + 4 * (m + n) + n * out_bytes
    return 2e3 * m * n * k / PEAK_INT8_OPS, 1e3 * nbytes / PEAK_BYTES_PER_S


def bound_of(ops_ms: float, bytes_ms: float):
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def quant_bound(m: int, k: int, k_out: int, extra_bytes: int = 0) -> float:
    """bound_ms of a row quantizer: bf16 [m, k] read once, s8 [m, k_out] and
    f32 [m] written once (+ extra_bytes of modulation / affine input)."""
    return (2.0 * m * k + m * k_out + 4 * m + extra_bytes) / PEAK_BYTES_PER_S * 1e3


def path_gemm_operands(dev, g, m, k, n):
    """Operands with the main path's statistics: per-token codes of a
    normal activation, per-channel codes of a U(-1/sqrt(K), 1/sqrt(K))
    weight (as init_params draws it), a bf16 bias; the weight K-contiguous."""
    x_q, xs = quantize_act_int8_per_token(
        torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16))
    w = (torch.rand(k, n, generator=g, device=dev) * 2 - 1) / k ** 0.5
    w_q, ws = quantize_weight_int8(w.to(torch.bfloat16))
    b = (torch.randn(n, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    return x_q, w_q.t().contiguous().t(), xs, ws, b


def gemm_operands(dev, g, m, k, n, per_token=True, per_channel=True,
                  out_dtype=torch.bfloat16, bias=True):
    """Uniformly random int8 codes (every magnitude up to 127: the largest
    sums), scales and bias; the weight K-contiguous as the generator holds
    it (an [N, K] tensor seen as [K, N])."""
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8).t()
    xs = torch.rand(m if per_token else 1, 1, generator=g, device=dev) * 0.05 + 1e-3
    ws = torch.rand(n if per_channel else 1, generator=g, device=dev) * 0.02 + 1e-4
    b = (torch.randn(n, generator=g, device=dev) * 0.1).to(out_dtype) if bias else None
    return x, w, xs, ws, b


def code_diff(got, want):
    """(max |code diff|, share of codes that differ, share of rounding
    events, max scale rel diff, max |dequantized diff|) of two (codes,
    scales) pairs, one scale a row. Events: the differing codes of rows
    whose scales agree, plus one for each row whose scale moved."""
    (gq, gs), (wq, ws) = got, want
    d = (gq.int() - wq.int()).abs()
    moved = (gs != ws).reshape(-1)
    flips = (d > 0).reshape(moved.shape[0], -1)
    events = flips[~moved].sum().item() + moved.sum().item()
    srel = ((gs - ws).abs() / ws).max().item()
    deq = (gq.float() * gs - wq.float() * ws).abs().max().item()
    return (d.max().item(), flips.float().mean().item(), events / d.numel(), srel,
            deq)


def every_bf16_absmax(dev: torch.device) -> torch.Tensor:
    """A row for each positive finite bf16 value M, holding M, the 1023 bf16
    values below it (8 binades) and the negatives of all 1024: every pair of
    a value and a row scale under which a code can be nonzero (a value below
    M / 256 has |v / scale| < 0.5), the 1e-8 scale floor included."""
    top = torch.arange(1, 0x7F80, device=dev, dtype=torch.int32)
    bits = (top[:, None] - torch.arange(1024, device=dev, dtype=torch.int32)).clamp(min=0)
    return torch.cat([bits, bits + 0x8000], dim=1).to(torch.int16).view(torch.bfloat16)


def quant_rate(ms: float, bound: float) -> str:
    return f"{100 * bound / ms:.1f}% of the bound's rate"


def check_quant_case(name, got, want, exact):
    dmax, share, events, srel, deq = code_diff(got, want)
    ok = ((dmax == 0 and srel == 0) if exact else
          (dmax <= CODE_TOL and events <= FLIP_SHARE and srel <= SCALE_RTOL))
    print(f"w8a8 case {name}: max |code diff| {dmax} (tol {0 if exact else CODE_TOL}), "
          f"share of codes that differ {share:.3e}, share of rounding events "
          f"{events:.3e} (tol {0 if exact else FLIP_SHARE:g}), max scale rel diff "
          f"{srel:.3e} (tol {0 if exact else SCALE_RTOL:g}), max |dequantized diff| "
          f"{deq:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, deq


def expect_raise(label, exc, fn):
    try:
        fn()
    except exc as e:
        print(f"guard {label}: {type(e).__name__} ok", flush=True)
        return
    raise AssertionError(f"{label}: the wrapper took an operand it cannot take")


def check_gemm_plan(m: int, n: int, kernel: str) -> None:
    """The launcher's tile plan (csrc/gemm_sm90.cu) equals the Python
    helper's on this card's SM count."""
    fn = _build.load_library(GEMM_LIBRARY).inferix_gemm_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = (ctypes.c_int * 3)()
    want = gemm_plan(m, n, kernel, sms)
    if fn(m, n, int(kernel == "fp8"), sms, got) != 0 or tuple(got) != want:
        raise AssertionError(f"{kernel} GEMM tile plan of [{m} x {n}]: kernel "
                             f"{tuple(got)}, helper {want}")


def gemm_rate(kind: str, m: int, k: int, n: int, ms: float, bound: float) -> str:
    """The time as a rate and as a share of the bound's rate."""
    unit = "TOP/s" if kind == "int8" else "TFLOP/s"
    return f"{2 * m * n * k / ms / 1e9:.1f} {unit}, {100 * bound / ms:.1f}% of the bound's rate"


def w8a8_kernel_phase(dev: torch.device) -> list:
    """The three W8A8 kernels against their plain versions, then timed."""
    g = torch.Generator(device=dev).manual_seed(2)
    counters = (int8_matmul, quantize_rows_int8, adaln_quantize_rows_int8,
                ln_quantize_rows_int8)
    failed = []

    # --- kernel 8: the int8 GEMM, bit-equal to its plain version
    gemm_cases = [(nm, m, k, n, {}) for nm, m, k, n, _ in LAYER_GEMMS] + [
        ("text_kv", TEXT, DIM, DIM, {}), ("ragged_m4681", SQ + 1, DIM, 3 * DIM, {}),
        ("m1", 1, DIM, DIM, {}),
        ("per_tensor", SQ, DIM, DIM, dict(per_token=False, per_channel=False)),
        ("f32_out", SQ, DIM, DIM, dict(out_dtype=torch.float32)),
        ("no_bias_k16", 100, 16, 8, dict(bias=False))] + [
        (nm, m, k, n, {}) for nm, m, k, n in sched_gemms("int8")]
    gemm_err = 0.0
    for nm, m, k, n, kw in gemm_cases:
        check_gemm_plan(m, n, "int8")
        x, w, xs, ws, b = gemm_operands(dev, g, m, k, n, **kw)
        od = kw.get("out_dtype", torch.bfloat16)
        out = int8_matmul(x, w, xs, ws, out_dtype=od, bias=b)
        torch.cuda.synchronize()
        ref = int8_matmul_reference(x, w, xs, ws, out_dtype=od, bias=b)
        err = (out.float() - ref.float()).abs().max().item()
        ok = err == 0 and out.dtype == od and torch.isfinite(out).all().item()
        print(f"w8a8 case int8_matmul {nm} [{m}x{k}]x[{k}x{n}] -> {od}: max_abs "
              f"{err:.3e} (tol 0) {'ok' if ok else 'FAIL'}", flush=True)
        gemm_err = max(gemm_err, err)
        if not ok:
            failed.append(f"int8_matmul {nm}")

    # --- kernel 5: the act-quant kernel, all four acts
    act_cases = (("o_in", SQ, DIM, None), ("text_in", TEXT, DIM, None),
                 ("m1", 1, DIM, None), ("fc2_in_gelu", SQ, FFN, "gelu"),
                 ("ragged_gelu", SQ + 1, FFN, "gelu"),
                 ("gelu_exact", SQ, FFN, "gelu_exact"),
                 ("silu_mul", SQ, 2 * FFN, "silu_mul"),
                 # the int8 K/V cache write at B=2: one row per (token, head)
                 ("kv_write_b2", 2 * SQ * H, D, None))
    act_err = 0.0
    for nm, m, k, act in act_cases:
        x = (torch.randn(m, k, generator=g, device=dev) * 2).to(torch.bfloat16)
        x[0] = 0  # an all-zero row takes the 1e-8 floor
        got = quantize_rows_int8(x, act=act)
        torch.cuda.synchronize()
        ok, deq = check_quant_case(f"quantize_rows_int8 {nm} [{m}x{k}] act {act}",
                                   got, quantize_rows_int8_reference(x, act), True)
        act_err = max(act_err, deq)
        if not ok:
            failed.append(f"quantize_rows_int8 {nm}")

    # --- kernels 6 and 7: LN + modulate, LN + affine, plain LN
    ln_err = 0.0
    for nm, b, f, s in (("adaln_qkv_fc1", 1, 3, SQ), ("adaln_b2", 2, 2, 3120)):
        x = (torch.randn(b, s, DIM, generator=g, device=dev) * 3 + 0.5).to(torch.bfloat16)
        mod = torch.randn(b, f, 6, DIM, generator=g, device=dev) * 0.5
        got = adaln_quantize_rows_int8(x, mod[:, :, 0], mod[:, :, 1])
        torch.cuda.synchronize()
        want = adaln_quantize_rows_int8_reference(x, mod[:, :, 0], mod[:, :, 1])
        ok, deq = check_quant_case(f"adaln_quantize_rows_int8 {nm} [{b}x{s}x{DIM}] "
                                   f"{f} frames", got, want, False)
        ln_err = max(ln_err, deq)
        if not ok:
            failed.append(f"adaln {nm}")
    w3 = (1 + 0.1 * torch.randn(DIM, generator=g, device=dev)).to(torch.bfloat16)
    b3 = (0.1 * torch.randn(DIM, generator=g, device=dev)).to(torch.bfloat16)
    for nm, m, affine in (("cross_q_affine", SQ, True), ("plain", SQ, False),
                          ("m1_affine", 1, True)):
        x = (torch.randn(m, DIM, generator=g, device=dev) * 3 - 1).to(torch.bfloat16)
        wb = (w3, b3) if affine else (None, None)
        got = ln_quantize_rows_int8(x, *wb)
        torch.cuda.synchronize()
        ok, deq = check_quant_case(f"ln_quantize_rows_int8 {nm} [{m}x{DIM}]", got,
                                   ln_quantize_rows_int8_reference(x, *wb), False)
        ln_err = max(ln_err, deq)
        if not ok:
            failed.append(f"ln {nm}")

    # --- the row classes' edges (ops/act_quant.row_plan), on a generator of
    # their own so that the cases above keep their inputs: every act in the
    # G 16 (width <= 128), G 32 (<= 1536) and G 128 (<= 9216, <= 12288)
    # classes and past them (the row read twice), M 1, M ragged against the
    # G 16 class's
    # two rows a group, the B=2 activations (M 9360) and the window's K/V
    # write; the LayerNorm kernel at each class with strided [B, F, 6, C]
    # modulation views, and frames of 13 rows, so that a group's run of rows
    # crosses frame boundaries (its modulation registers are reloaded).
    ge = torch.Generator(device=dev).manual_seed(12)
    for nm, m, k, act in (
            ("k8", 4999, 8, None), ("k120_gelu_exact", 4999, 120, "gelu_exact"),
            ("k128_silu_mul", 4999, 256, "silu_mul"), ("k128_gelu_m1", 1, 128, "gelu"),
            ("kv_write_window", SQ * H, D, None), ("kv_ragged", 2 * SQ * H + 1, D, None),
            ("k136_gelu", 4999, 136, "gelu"), ("k1544", 4999, 1544, None),
            ("k9216_gelu", 999, 9216, "gelu"), ("k9224", 999, 9224, None),
            ("k1544_silu_mul", 4999, 2 * 1544, "silu_mul"),
            ("o_in_b2", 2 * SQ, DIM, None), ("k2056_gelu_exact", 4999, 2056, "gelu_exact"),
            ("fc2_in_gelu_b2", 2 * SQ, FFN, "gelu"), ("fc2_in_gelu_m1", 1, FFN, "gelu"),
            ("k12288", 4999, 12288, None), ("k12288_silu_mul", 999, 2 * 12288, "silu_mul"),
            ("k12296_two_pass", 4999, 12296, None),
            ("k12296_two_pass_gelu", 999, 12296, "gelu"),
            ("k16384_two_pass_silu_mul", 999, 2 * 16384, "silu_mul")):
        x = (torch.randn(m, k, generator=ge, device=dev) * 2).to(torch.bfloat16)
        x[0] = 0
        got = quantize_rows_int8(x, act=act)
        torch.cuda.synchronize()
        g_nc = row_plan(k // 2 if act == "silu_mul" else k)
        ok, deq = check_quant_case(f"quantize_rows_int8 {nm} [{m}x{k}] act {act} G, chunks "
                                   f"{g_nc}", got, quantize_rows_int8_reference(x, act), True)
        act_err = max(act_err, deq)
        if not ok:
            failed.append(f"quantize_rows_int8 {nm}")
    # the quotient from the row's reciprocal against IEEE division: every
    # code that can be nonzero, under every bf16 absmax
    x = every_bf16_absmax(dev)
    got = quantize_rows_int8(x)
    torch.cuda.synchronize()
    ok, deq = check_quant_case(f"quantize_rows_int8 every_bf16_absmax [{x.shape[0]}x"
                               f"{x.shape[1]}] act None", got, quantize_rows_int8_reference(x),
                               True)
    if not ok:
        failed.append("quantize_rows_int8 every_bf16_absmax")
    for nm, b, f, s, c in (("adaln_fs13", 1, 360, SQ, DIM),
                           ("adaln_c3072_b2_fs13", 2, 180, SQ // 2, 3072),
                           ("adaln_c6144", 1, 3, SQ, 6144), ("adaln_c12288", 1, 2, 2080, 12288),
                           ("adaln_c128_fs13", 2, 180, SQ // 2, 128),
                           ("adaln_b2_m9360", 2, 3, SQ, DIM)):
        x = (torch.randn(b, s, c, generator=ge, device=dev) * 3 + 0.5).to(torch.bfloat16)
        mod = torch.randn(b, f, 6, c, generator=ge, device=dev) * 0.5
        got = adaln_quantize_rows_int8(x, mod[:, :, 0], mod[:, :, 1])
        torch.cuda.synchronize()
        want = adaln_quantize_rows_int8_reference(x, mod[:, :, 0], mod[:, :, 1])
        ok, deq = check_quant_case(f"adaln_quantize_rows_int8 {nm} [{b}x{s}x{c}] {f} frames "
                                   f"G, chunks {row_plan(c)}", got, want, False)
        ln_err = max(ln_err, deq)
        if not ok:
            failed.append(f"adaln {nm}")
    for nm, m, c, affine in (("c3072_affine", SQ, 3072, True), ("c6144_plain", SQ, 6144, False),
                             ("c12288_affine", 2080, 12288, True), ("c128_affine", 4999, 128, True),
                             ("c1544_plain", 4999, 1544, False),
                             ("cross_q_affine_m9360", 2 * SQ, DIM, True)):
        x = (torch.randn(m, c, generator=ge, device=dev) * 3 - 1).to(torch.bfloat16)
        wb = ((1 + 0.1 * torch.randn(c, generator=ge, device=dev)).to(torch.bfloat16),
              (0.1 * torch.randn(c, generator=ge, device=dev)).to(torch.bfloat16)) \
            if affine else (None, None)
        got = ln_quantize_rows_int8(x, *wb)
        torch.cuda.synchronize()
        ok, deq = check_quant_case(f"ln_quantize_rows_int8 {nm} [{m}x{c}] G, chunks "
                                   f"{row_plan(c)}", got, ln_quantize_rows_int8_reference(x, *wb),
                                   False)
        ln_err = max(ln_err, deq)
        if not ok:
            failed.append(f"ln {nm}")

    # --- each wrapper raises on a CUDA operand its kernel cannot take
    x, w, xs, ws, b = gemm_operands(dev, g, 64, DIM, DIM)
    expect_raise("int8_matmul N-contiguous weight", ValueError,
                 lambda: int8_matmul(x, w.contiguous(), xs, ws, bias=b))
    expect_raise("int8_matmul K % 16", ValueError,
                 lambda: int8_matmul(x[:, :40], w[:40], xs, ws, bias=b))
    xf = torch.randn(64, DIM, device=dev)
    expect_raise("quantize_rows_int8 float32", TypeError, lambda: quantize_rows_int8(xf))
    expect_raise("adaln float32", TypeError, lambda: adaln_quantize_rows_int8(
        xf[None], xs[None, :1].expand(1, 1, DIM), xs[None, :1].expand(1, 1, DIM)))
    expect_raise("ln float32 affine weight", ValueError, lambda: ln_quantize_rows_int8(
        xf.to(torch.bfloat16), w3.float(), b3))
    xb = torch.zeros(64, 12304, dtype=torch.bfloat16, device=dev)
    expect_raise("quantize_rows_int8 K % 8", ValueError, lambda: quantize_rows_int8(xb[:, :12]))
    expect_raise("quantize_rows_int8 silu_mul K % 16", ValueError,
                 lambda: quantize_rows_int8(xb[:, :24].contiguous(), act="silu_mul"))
    expect_raise("ln C past the register classes", ValueError,
                 lambda: ln_quantize_rows_int8(xb[:, :12296].contiguous()))
    # the launchers take no class they were not built for (G 64, G 32 with 9
    # chunks a thread) nor a plan that does not cover the row exactly
    q8 = torch.empty(64, 12304, dtype=torch.int8, device=dev)
    s8 = torch.empty(64, 1, device=dev)
    lib = _build.load_library("act_quant")
    stream = torch.cuda.current_stream().cuda_stream
    for k, g_cls, nc in ((2048, 64, 4), (2304, 32, 9), (1536, 32, 5), (1536, 32, 7),
                         (128, 16, 2)):
        err = lib.inferix_quantize_rows_int8(xb.data_ptr(), q8.data_ptr(), s8.data_ptr(),
                                             64, k, 0, g_cls, nc, stream)
        err_ln = lib.inferix_ln_quantize_rows_int8(
            xb.data_ptr(), q8.data_ptr(), s8.data_ptr(), None, None, 0, 0, 64, k, 64, 64,
            1e-6, 0, g_cls, nc, stream)
        if err == 0 or err_ln == 0:
            raise AssertionError(f"an act-quant launcher took the class G {g_cls}, {nc} "
                                 f"chunks a thread for width {k}")
        print(f"guard act-quant launchers refuse G {g_cls}, {nc} chunks at width {k}: ok",
              flush=True)
    err = lib.inferix_ln_quantize_rows_int8(
        xb.data_ptr(), q8.data_ptr(), s8.data_ptr(), None, None, 0, 0, 64, 12296, 64, 64,
        1e-6, 0, *row_plan(12296), stream)
    if err == 0:
        raise AssertionError("the LayerNorm launcher took a row past its register classes")
    print("guard ln launcher refuses width 12296 (two-pass class): ok", flush=True)
    if failed:
        raise AssertionError(f"W8A8 kernel cases {failed} disagree with the plain versions")

    # --- times at the main path's shapes, one layer's worth of each kernel
    launches_before = [c.launches for c in counters]
    gemm = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for nm, m, k, n, calls in LAYER_GEMMS + (("text_kv", TEXT, DIM, DIM, 0),):
        x, w, xs, ws, b = path_gemm_operands(dev, g, m, k, n)
        ms = time_ms(lambda: int8_matmul(x, w, xs, ws, bias=b))
        plain = time_ms(lambda: int8_matmul_reference(x, w, xs, ws, bias=b))
        try:  # the yardstick only: int8 -> int32, no epilogue
            lib = time_ms(lambda: torch._int_mm(x, w))
        except RuntimeError as e:
            print(f"torch._int_mm refused [{m}x{k}]x[{k}x{n}]: {e}", flush=True)
            lib = None
        wbf = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
        xbf = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        lin = time_ms(lambda: F.linear(xbf, wbf, b))
        ops_ms, bytes_ms = gemm_times(m, k, n)
        bound, by = bound_of(ops_ms, bytes_ms)
        print(f"w8a8 time int8_matmul {nm} [{m}x{k}]x[{k}x{n}]: {ms:.4f} ms "
              f"({gemm_rate('int8', m, k, n, ms, bound)}), bound {bound:.4f} ms ({by}), "
              f"plain {plain:.4f} ms, torch._int_mm {lib} ms, "
              f"bf16 F.linear {lin:.4f} ms", flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            gemm[key] = None if v is None or gemm[key] is None else gemm[key] + calls * v
    gemm["bound_ms"], gemm["bound_by"] = bound_of(gemm["ops_ms"], gemm["bytes_ms"])

    act = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for nm, k, a, calls in (("o/cross_o", DIM, None, 2), ("fc2_in", FFN, "gelu", 1)):
        x = (torch.randn(SQ, k, generator=g, device=dev) * 2).to(torch.bfloat16)
        ms = time_ms(lambda: quantize_rows_int8(x, act=a))
        plain = time_ms(lambda: quantize_rows_int8_reference(x, a))
        bound = quant_bound(SQ, k, k)
        print(f"w8a8 time quantize_rows_int8 {nm} [{SQ}x{k}] act {a}: {ms:.4f} ms "
              f"({quant_rate(ms, bound)}), bound {bound:.4f} ms (bytes), plain "
              f"{plain:.4f} ms", flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
            act[key] += calls * v
    for nm, k, a in (("o/cross_o B=2", DIM, None), ("fc2_in B=2", FFN, "gelu")):
        x = (torch.randn(2 * SQ, k, generator=ge, device=dev) * 2).to(torch.bfloat16)
        ms, bound = time_ms(lambda: quantize_rows_int8(x, act=a)), quant_bound(2 * SQ, k, k)
        print(f"w8a8 time quantize_rows_int8 {nm} [{2 * SQ}x{k}] act {a}: {ms:.4f} ms "
              f"({quant_rate(ms, bound)}), bound {bound:.4f} ms (bytes)", flush=True)

    # the int8 K/V write of one block at B=2 (K or V; 2 a layer-forward)
    x = torch.randn(2, SQ, H, D, generator=g, device=dev).to(torch.bfloat16)
    kv_write = dict(ms=time_ms(lambda: quantize_kv_block(x)),
                    plain_ms=time_ms(lambda: quantize_rows_int8_reference(
                        x.reshape(-1, D))),
                    bound_ms=quant_bound(2 * SQ * H, D, D), bound_by="bytes",
                    work=f"one int8 K (or V) block write at B=2: quantize_kv_block "
                         f"[2,{SQ},{H},{D}], {2 * SQ * H} rows of {D}")
    print(f"w8a8 time quantize_rows_int8 kv_write_b2 [{2 * SQ * H}x{D}] act None: "
          f"{kv_write['ms']:.4f} ms ({quant_rate(kv_write['ms'], kv_write['bound_ms'])}), "
          f"bound {kv_write['bound_ms']:.4f} ms (bytes), plain {kv_write['plain_ms']:.4f} ms",
          flush=True)
    xw = x[:1]  # the rolling window's write: B=1, 56160 rows of 128
    ms, bound = time_ms(lambda: quantize_kv_block(xw)), quant_bound(SQ * H, D, D)
    print(f"w8a8 time quantize_rows_int8 kv_write_window [{SQ * H}x{D}] act None: {ms:.4f} ms "
          f"({quant_rate(ms, bound)}), bound {bound:.4f} ms (bytes)", flush=True)

    ln = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    x = (torch.randn(1, SQ, DIM, generator=g, device=dev) * 3).to(torch.bfloat16)
    mod = torch.randn(1, 3, 6, DIM, generator=g, device=dev) * 0.5
    for nm, fn, plain_fn, extra, calls in (
            ("adaln qkv/fc1", lambda: adaln_quantize_rows_int8(x, mod[:, :, 0], mod[:, :, 1]),
             lambda: adaln_quantize_rows_int8_reference(x, mod[:, :, 0], mod[:, :, 1]),
             2 * 3 * DIM * 4, 2),
            ("ln affine cross_q", lambda: ln_quantize_rows_int8(x[0], w3, b3),
             lambda: ln_quantize_rows_int8_reference(x[0], w3, b3), 2 * DIM * 2, 1)):
        ms, plain = time_ms(fn), time_ms(plain_fn)
        bound = quant_bound(SQ, DIM, DIM, extra)
        print(f"w8a8 time {nm} [{SQ}x{DIM}]: {ms:.4f} ms ({quant_rate(ms, bound)}), bound "
              f"{bound:.4f} ms (bytes), plain {plain:.4f} ms", flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
            ln[key] += calls * v
    x2 = (torch.randn(2, SQ, DIM, generator=ge, device=dev) * 3).to(torch.bfloat16)
    mod2 = torch.randn(2, 3, 6, DIM, generator=ge, device=dev) * 0.5
    for nm, fn, extra in (
            ("adaln qkv/fc1 B=2", lambda: adaln_quantize_rows_int8(x2, mod2[:, :, 0],
                                                                   mod2[:, :, 1]),
             2 * 2 * 3 * DIM * 4),
            ("ln affine cross_q B=2", lambda: ln_quantize_rows_int8(x2.reshape(-1, DIM), w3, b3),
             2 * DIM * 2)):
        ms, bound = time_ms(fn), quant_bound(2 * SQ, DIM, DIM, extra)
        print(f"w8a8 time {nm} [{2 * SQ}x{DIM}]: {ms:.4f} ms ({quant_rate(ms, bound)}), "
              f"bound {bound:.4f} ms (bytes)", flush=True)
    for c, before in zip(counters, launches_before):
        c.launches = before  # timing launches are not the main path's
    print(f"w8a8 per layer: int8_matmul {gemm['ms']:.4f} ms (bound {gemm['bound_ms']:.4f}, "
          f"_int_mm {gemm['library_ms']}), quantize_rows_int8 {act['ms']:.4f} ms "
          f"(bound {act['bound_ms']:.4f}), LN prologues {ln['ms']:.4f} ms "
          f"(bound {ln['bound_ms']:.4f})", flush=True)
    per_layer = "one W8A8 layer at M=4680 (sum over its calls)"
    return [
        {"name": "int8_matmul", "route": "cuda",
         "source": "inferix_tpu_torch/csrc/gemm_sm90.cu",
         "replaces": "inferix_tpu/quant/kernels.py:81", "launches": None,
         "max_abs_err": gemm_err, "ms": gemm["ms"], "plain_ms": gemm["plain_ms"],
         "bound_ms": gemm["bound_ms"], "bound_by": gemm["bound_by"],
         "library_ms": gemm["library_ms"], "work": per_layer + ", 6 GEMMs"},
        {"name": "quantize_rows_int8", "route": "cuda",
         "source": "inferix_tpu_torch/csrc/act_quant.cu",
         "replaces": "inferix_tpu/ops/act_quant.py:66", "launches": None,
         "max_abs_err": act_err, "ms": act["ms"], "plain_ms": act["plain_ms"],
         "bound_ms": act["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "work": per_layer + ", o + cross-o + fc2 (gelu) inputs", "kv_write": kv_write},
        {"name": "ln_modulate_quant", "route": "cuda",
         "source": "inferix_tpu_torch/csrc/act_quant.cu",
         "replaces": "inferix_tpu/ops/act_quant.py:154", "launches": None,
         "max_abs_err": ln_err, "ms": ln["ms"], "plain_ms": ln["plain_ms"],
         "bound_ms": ln["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "work": per_layer + ", 2 LN+modulate (qkv, fc1) + 1 LN+affine (cross-q)"},
    ]


KERNEL_COUNTERS = {  # name -> (wrapper, attribute holding its launch count)
    "int8_matmul": (int8_matmul, "launches"),
    "quantize_rows_int8": (quantize_rows_int8, "launches"),
    "adaln": (adaln_quantize_rows_int8, "launches"),
    "ln": (ln_quantize_rows_int8, "launches"),
    "flash_attention_prefix": (flash_attention_prefix, "launches"),
    "flash_attention_prefix_fp8": (flash_attention_prefix, "launches_fp8"),
    "flash_attention_prefix_quant": (flash_attention_prefix_quant, "launches"),
    "halo_conv3d": (halo_conv3d, "launches"),
    "halo_conv3d_w8a8": (halo_conv3d_w8a8, "launches"),
    "quantize_conv_act": (quantize_conv_act, "launches"),
    "fp8_matmul": (fp8_matmul, "launches"),
    "flash_attention_prefix_quant_i8": (flash_attention_prefix_quant_i8, "launches"),
    "flash_attention_prefix_quant_v2": (flash_attention_prefix_quant_v2, "launches"),
}


def all_counts() -> dict:
    return {k: getattr(f, a) for k, (f, a) in KERNEL_COUNTERS.items()}


def reset_counts() -> None:
    for f, a in KERNEL_COUNTERS.values():
        setattr(f, a, 0)


def restore_counts(before: dict) -> None:
    """Put the counts back to `before`: timing launches are not a path's."""
    for k, (f, a) in KERNEL_COUNTERS.items():
        setattr(f, a, before[k])


def count_diff(now: dict, before: dict) -> dict:
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def counts() -> dict:
    """The launch counts of the W8A8 path's kernels."""
    now = all_counts()
    return {k: now[k] for k in ("int8_matmul", "quantize_rows_int8", "adaln", "ln",
                                "flash_attention_prefix")}


@contextlib.contextmanager
def plain_versions():
    """Every W8A8 kernel and the attention kernel replaced by its plain
    version, where the model looks them up."""
    with contextlib.ExitStack() as stack:
        for name, fn in (("int8_matmul", int8_matmul_reference),
                         ("quantize_rows_int8", quantize_rows_int8_reference),
                         ("adaln_quantize_rows_int8", adaln_quantize_rows_int8_reference),
                         ("ln_quantize_rows_int8", ln_quantize_rows_int8_reference)):
            stack.enter_context(mock.patch.object(quant_api, name, fn))
        stack.enter_context(mock.patch.object(attention_mod, "flash_attention",
                                              plain_flash_attention))
        yield


def w8a8_main_phase(dev: torch.device, blocks: int) -> dict:
    """Generate `blocks` blocks with W8A8 linears; returns the launches of
    each kernel over the path (text encode included)."""
    t0 = time.perf_counter()
    cfg = main_path_config(blocks, w8a8=True)
    m, r = cfg.model, cfg.runtime
    fpb = m.num_frame_per_block
    reset_counts()
    gen, xattn, noise, g = main_path_setup(dev, cfg)
    torch.cuda.synchronize()
    text = counts()
    want_text = {"int8_matmul": 2 * m.num_layers, "quantize_rows_int8": 2 * m.num_layers,
                 "adaln": 0, "ln": 0, "flash_attention_prefix": 0}
    print(f"w8a8 setup (weights quantized, {memory_bytes(gen.params['blocks']) / 2**30:.3f} "
          f"GiB of block weights, text K/V): {time.perf_counter() - t0:.3f} s, "
          f"launches at text encode {text}", flush=True)
    if text != want_text:
        raise AssertionError(f"text-encode launches {text}, want {want_text}")

    forwards = len(gen.denoising_steps) + 1
    n = m.num_layers * forwards
    want_block = {"int8_matmul": 6 * n, "quantize_rows_int8": 3 * n, "adaln": 2 * n,
                  "ln": n, "flash_attention_prefix": n}
    per_block, marks, prev = [], [time.perf_counter()], [dict(text)]

    def on_block(x0, bi):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        now = counts()
        per_block.append({k: now[k] - prev[0][k] for k in now})
        prev[0] = now
        print(f"w8a8 block {bi}: {marks[-1] - marks[-2]:.3f} s, launches "
              f"{per_block[-1]}", flush=True)

    latents, cache = gen.generate(noise, xattn, generator=g, block_callback=on_block)
    torch.cuda.synchronize()
    total = counts()
    if per_block != [want_block] * blocks:
        raise AssertionError(f"W8A8 launches per block {per_block}, want {want_block}")
    shape = (1, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError(f"W8A8 latents {tuple(latents.shape)} (want {shape}) "
                             "or not finite")
    end = r.num_frames * gen.frame_seq
    for buf in (cache.k, cache.v):
        if not (buf[:, :, :end].abs().amax(dim=(-1, -2)) > 0).all():
            raise AssertionError("a written W8A8 cache slot is zero")
        if buf[:, :, end:].any():
            raise AssertionError("a W8A8 cache slot past the span was written")
    print(f"w8a8 main path: latents {tuple(latents.shape)} finite, |x0| max "
          f"{latents.float().abs().max().item():.3f}, launches {total}", flush=True)

    # one layer, then one whole forward, every kernel vs every plain version
    f0 = r.num_frames - fpb
    start = f0 * gen.frame_seq
    geo, spec = gen.statics.geo, gen.statics.spec
    x_blk = latents[:, f0:]
    t = torch.full((1, fpb), gen.denoising_steps[0], device=dev)
    with torch.inference_mode():
        tokens = patch_embed(gen.params, m, x_blk)
        _, e0 = time_embeddings(gen.params, m, t)
        angles = rope_angles(gen.rope_tables, fpb, geo.grid_h, geo.grid_w, f0)
        mask = valid_mask(spec, start + geo.tokens, device=dev)
        blk = layer_params(gen.params["blocks"], 0)
        ys, flows = [], []
        for plain in (False, True):
            before = counts()
            with plain_versions() if plain else contextlib.nullcontext():
                lc = (cache.k[0].clone(), cache.v[0].clone())
                y, _ = block_forward(blk, m, spec, tokens, e0, angles, lc, xattn.k[0],
                                     xattn.v[0], start, mask)
                flow, _ = dit_forward_inference(gen.params, gen.statics, gen.rope_tables,
                                                x_blk, t, xattn, cache, start)
            if plain and counts() != before:
                raise AssertionError("a plain-version run launched a kernel")
            ys.append(y)
            flows.append(flow)
        layer_err = rel_err(ys[0] - tokens, ys[1] - tokens)
        fwd_err = rel_err(flows[0], flows[1])
    print(f"w8a8 block_forward kernels vs plain: update rel err {layer_err:.3e} "
          f"(tol {W8A8_LAYER_RTOL:g})", flush=True)
    print(f"w8a8 dit_forward_inference kernels vs plain: flow rel err {fwd_err:.3e} "
          f"(tol {W8A8_FORWARD_RTOL:g})", flush=True)
    if not (layer_err <= W8A8_LAYER_RTOL and fwd_err <= W8A8_FORWARD_RTOL):
        raise AssertionError("the W8A8 path with its kernels disagrees with the plain versions")

    # for information: the W8A8 flow against the bf16 flow, same weights
    del gen
    bgen, bxattn, _, _ = main_path_setup(dev, main_path_config(blocks))
    with torch.inference_mode():
        bflow, _ = dit_forward_inference(bgen.params, bgen.statics, bgen.rope_tables,
                                         x_blk, t, bxattn, cache, start)
    print(f"w8a8 vs bf16 (information, not a gate): flow rel err "
          f"{rel_err(flows[0], bflow):.3e}", flush=True)
    phase("w8a8 main", t0)
    return total


# ---------------------------------------------------------------------------
# The int8 / fp8 KV caches and the rolling window (TPU kernels 1 with e4m3
# K/V and 2), and the VAE decode (TPU kernels 10 and 11)
# ---------------------------------------------------------------------------

WINDOW_FRAMES, SINK_FRAMES = 12, 1  # bench.py:94-108's rolling window
WINDOW_KEYS = WINDOW_FRAMES * 1560  # 18720: no attention past the window
WINDOW_BLOCKS = 5                   # 15 frames through a 12-frame window: the ring wraps

# VAE decode. A bf16 conv kernel and its plain version sum the same exact
# bf16 products in f32 in other orders (differences ~1e-6 of the sum of the
# products' magnitudes) and round to bf16: an output at a rounding boundary
# may round the other way (one bf16 ulp, at most 2^-7 |out|), and an output
# near 0 differs by the f32 difference itself, ~3e-5 rms(out) at these
# widths. Per element, rms over the conv's output:
#     |out_kernel - out_plain| <= CONV_TOL * (|out_plain| + 2^-4 rms)
# The W8A8 kernel sums integers exactly and applies the plain version's
# epilogue: bit-equal.
CONV_TOL = 2.0 ** -7
# Each W8A8 conv of the decode against the float32 conv of the same bf16
# input: tests/test_halo_conv.py's W8A8 bound.
W8A8_CONV_BOUND = 0.05   # max |w8a8 - f32| <= this * max |f32|
# The halo decode against the cuDNN ("xla") decode, both bf16: the xla path
# rounds each conv to bf16 and then adds the bias in bf16 (the JAX order),
# the halo kernel adds it in f32 and rounds once, so ~30 conv outputs differ
# by up to an ulp (2^-8) in a large share of their elements, and the
# differences pass through the norms and the later convs (8.6e-3 on a tiny
# decoder of 8 convs, CPU). A wrong tap, border or channel chunk moves the
# video by O(1); the kernel checks above hold each conv far tighter.
HALO_DECODE_RTOL = 5e-2  # ||video_halo - video_xla|| / ||video_xla||
LATENT_FRAMES = 6        # two 3-frame chunks -> 21 pixel frames
# The decode's stride-1 3x3(x3) conv classes at full width, with the frame
# counts of a chunk that is not the stream's first (3 latent frames): (name,
# Tin, H, W, Cin, Cout, kt, calls a chunk with "halo", with "halo_w8a8").
VAE_CONVS = (
    ("conv1 16->384 60x104", 5, 60, 104, 16, 384, 3, 1, 1),
    ("res 384 60x104", 5, 60, 104, 384, 384, 3, 10, 10),
    ("up 384->192 120x208", 6, 120, 208, 384, 192, 1, 0, 1),
    ("res 192->384 120x208", 8, 120, 208, 192, 384, 3, 1, 1),
    ("res 384 120x208", 8, 120, 208, 384, 384, 3, 5, 5),
    ("up 384->192 240x416", 12, 240, 416, 384, 192, 1, 0, 1),
    ("res 192 240x416", 14, 240, 416, 192, 192, 3, 6, 6),
    ("up 192->96 480x832", 12, 480, 832, 192, 96, 1, 0, 1),
    ("res 96 480x832", 14, 480, 832, 96, 96, 3, 6, 6),
    ("head 96->3 480x832", 14, 480, 832, 96, 3, 3, 1, 1),
)
# kernel launches a decode chunk: every conv of the decode runs once a chunk,
# each W8A8 conv behind one activation quantization
DECODE_LAUNCHES = {"xla": {}, "halo": {"halo_conv3d": sum(c[7] for c in VAE_CONVS)},
                   "halo_w8a8": {"halo_conv3d_w8a8": sum(c[8] for c in VAE_CONVS),
                                 "quantize_conv_act": sum(c[8] for c in VAE_CONVS)}}
# The encoder's stride-1 3x3x3 conv classes at 480x832 (the encode phase's 9
# frames: a chunk of 1 frame, then chunks of 4), in the same fields; the
# calls are a chunk of 4 frames'. The first chunk runs the same convs over 3
# frames (its 60x104 classes equal the later chunks'). The stride-2
# downsample convs and the temporal time_convs are not halo convs (cuDNN in
# every impl), so W8A8 takes the same 22 convs as bf16.
ENCODE_CONVS = (
    ("enc conv1 3->96 480x832", 6, 480, 832, 3, 96, 3, 1, 1),
    ("enc res 96 480x832", 6, 480, 832, 96, 96, 3, 4, 4),
    ("enc res 96->192 240x416", 6, 240, 416, 96, 192, 3, 1, 1),
    ("enc res 192 240x416", 6, 240, 416, 192, 192, 3, 3, 3),
    ("enc res 192->384 120x208", 4, 120, 208, 192, 384, 3, 1, 1),
    ("enc res 384 120x208", 4, 120, 208, 384, 384, 3, 3, 3),
    ("enc res 384 60x104", 3, 60, 104, 384, 384, 3, 8, 8),
    ("enc head 384->32 60x104", 3, 60, 104, 384, 32, 3, 1, 1),
    ("enc conv1 3->96 480x832, first chunk", 3, 480, 832, 3, 96, 3, 0, 0),
    ("enc res 96 480x832, first chunk", 3, 480, 832, 96, 96, 3, 0, 0),
    ("enc res 96->192 240x416, first chunk", 3, 240, 416, 96, 192, 3, 0, 0),
    ("enc res 192 240x416, first chunk", 3, 240, 416, 192, 192, 3, 0, 0),
    ("enc res 192->384 120x208, first chunk", 3, 120, 208, 192, 384, 3, 0, 0),
    ("enc res 384 120x208, first chunk", 3, 120, 208, 384, 384, 3, 0, 0),
)
ENCODE_CHUNK_CONVS = sum(c[7] for c in ENCODE_CONVS)  # 22, in every chunk
ENCODE_LAUNCHES = {"xla": {}, "halo": {"halo_conv3d": ENCODE_CHUNK_CONVS},
                   "halo_w8a8": {"halo_conv3d_w8a8": ENCODE_CHUNK_CONVS,
                                 "quantize_conv_act": ENCODE_CHUNK_CONVS}}
ENCODE_FRAMES = 9        # chunks of 1, 4, 4 pixel frames -> 3 latent frames
# The W8A8 decode's halo conv kernel (B7) and the activation quantization
# kernel, as the old row 11 (conv + the wrapper's float32 quantization) was
# measured: PERF.md keeps the old times beside the new.


def check_attention_case(label: str, out, lse, ref, ref_lse) -> tuple:
    """Kernel vs plain version with ATTN_TOL per element and LSE_ATOL;
    prints one line; returns (ok, max |diff|)."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    rms = ref.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
    bound = ATTN_TOL * (ref.abs() + rms)
    share = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0)).max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = share <= 1 and lse_err <= LSE_ATOL and torch.isfinite(out).all().item()
    print(f"{label}: max_abs {err:.3e} max |diff|/({ATTN_TOL:g}*(|ref|+rms)) "
          f"{share:.3f} (tol 1) lse_max_abs {lse_err:.3e} (tol {LSE_ATOL:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, err


def dequantize(k, k_scale, dtype=torch.bfloat16):
    return (k.float() * k_scale[..., None]).to(dtype)


def kv_kernel_phase(dev: torch.device) -> list:
    """The int8-KV kernel (B2) and the e4m3 instantiation of the flash
    kernel against their plain versions at the full-cache shape, then timed
    beside the bound and SDPA over a dequantized bf16 copy."""
    g = torch.Generator(device=dev).manual_seed(3)
    q2 = torch.randn(2, SQ, H, D, generator=g, device=dev).to(torch.bfloat16)
    kb = torch.randn(2, SKV, H, D, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(2, SKV, H, D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(kb)
    vq, vs = quantize_kv_block(vb)
    torch.cuda.synchronize()
    for name, x, codes, scales in (("k", kb, kq, ks), ("v", vb, vq, vs)):
        # the int8 cache write (the act-quant kernel, act None): exact
        ok, _ = check_quant_case(
            f"quantize_kv_block {name} [2,{SKV},{H},{D}]",
            (codes.reshape(-1, D), scales.reshape(-1, 1)),
            quantize_rows_int8_reference(x.reshape(-1, D)), True)
        if not ok:
            raise AssertionError("the int8 K/V write disagrees with its plain version")
    k8, v8 = (x.float().clamp(-448, 448).to(FP8) for x in (kb, vb))
    del kb, vb
    rows = (torch.tensor([0, 1000], device=dev), torch.tensor([9360, 32760], device=dev))
    spans = [  # (name, batch rows, kv_start, kv_len, softmax)
        ("len1", 1, 0, 1, "fixedm"), ("empty", 1, 4680, 4680, "fixedm"),
        ("len32760", 1, 0, SKV, "fixedm"), ("len32760_runmax", 1, 0, SKV, "runmax"),
        ("start1000_len14040", 1, 1000, 14040, "fixedm"),
        ("start1000_len14040_runmax", 1, 1000, 14040, "runmax"),
        ("b2_rows", 2, rows[0], rows[1], "fixedm"),
        ("b2_rows_runmax", 2, rows[0], rows[1], "runmax")]
    kinds = {
        "flash_attention_prefix_quant": (
            lambda b, *a, **kw: flash_attention_prefix_quant(
                q2[:b], kq[:b], vq[:b], ks[:b], vs[:b], *a, **kw),
            lambda b, *a, **kw: flash_attention_prefix_quant_reference(
                q2[:b], kq[:b], vq[:b], ks[:b], vs[:b], *a, **kw)),
        "flash_attention_prefix_fp8": (
            lambda b, *a, **kw: flash_attention_prefix(q2[:b], k8[:b], v8[:b], *a, **kw),
            lambda b, *a, **kw: flash_attention_prefix_reference(
                q2[:b], k8[:b], v8[:b], *a, **kw)),
    }
    entries, failed = [], []
    for name, (kern, plain) in kinds.items():
        worst = 0.0
        for case, b, start, end, sm in spans:
            out, lse = kern(b, end, start, softmax=sm, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = plain(b, end, start, softmax=sm, return_lse=True)
            ok, err = check_attention_case(f"kv case {name} {case}", out, lse, ref, ref_lse)
            worst = max(worst, err)
            if not ok:
                failed.append(f"{name} {case}")
        before = all_counts()
        ms = time_ms(lambda: kern(1, SKV))
        plain_ms = time_ms(lambda: plain(1, SKV), iters=3, warmup=1)
        if name == "flash_attention_prefix_quant":
            kd, vd = dequantize(kq[:1], ks[:1]), dequantize(vq[:1], vs[:1])
        else:
            kd, vd = k8[:1].to(torch.bfloat16), v8[:1].to(torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q2[:1], kd, vd))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        if name == "flash_attention_prefix_quant":
            # for information: the in-kernel dequantization against the
            # plain path's (dequantize K/V to bf16, then attend)
            deq = flash_attention_prefix_reference(q2[:1], kd, vd, SKV)
            print(f"kv {name} full cache vs dequantize-then-attend (information): "
                  f"rel err {rel_err(kern(1, SKV), deq):.3e}", flush=True)
            del deq
        del kd, vd, qt, kt, vt
        restore_counts(before)
        # the spans of the paths (block 0 / 2 / 6 of a clip), each beside its
        # bound and SDPA over a dequantized copy of the same span; int8 at
        # B=1 and B=2 (the int8-KV path runs at B=2)
        if name == "flash_attention_prefix_quant":
            span_times(flash_attention_prefix_quant, f"kv time {name}", q2, kq, vq,
                       (1, 2), ks, vs)
        else:
            span_times(flash_attention_prefix, f"kv time {name}", q2, k8, v8, (1,))
        bound_ms, bound_by = attention_bound(1, SQ, SKV)
        print(f"kv time {name} full cache: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa over a dequantized bf16 copy {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "inferix_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": ("inferix_tpu/ops/flash_attention.py:390"
                         if name == "flash_attention_prefix_quant"
                         else "inferix_tpu/ops/flash_attention.py:53"),
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    # the wrappers refuse what their kernels cannot take
    expect_raise("flash_attention_prefix_quant bf16 K/V", TypeError,
                 lambda: flash_attention_prefix_quant(q2[:1], k8[:1].to(torch.bfloat16),
                                                      k8[:1].to(torch.bfloat16), ks[:1],
                                                      vs[:1], SKV))
    expect_raise("flash_attention_prefix_quant bf16 scales", ValueError,
                 lambda: flash_attention_prefix_quant(q2[:1], kq[:1], vq[:1],
                                                      ks[:1].bfloat16(), vs[:1], SKV))
    expect_raise("flash_attention_prefix int8 K/V", TypeError,
                 lambda: flash_attention_prefix(q2[:1], kq[:1], vq[:1], SKV))
    # the tensor maps' rule: K/V strides that are positive multiples of 16
    # bytes, at least one token
    kpad = torch.zeros(1, 64, H * D + 8, dtype=torch.int8, device=dev)
    k_odd = kpad[..., :H * D].view(1, 64, H, D)          # token stride 1544 bytes
    expect_raise("flash_attention_prefix_quant token stride 1544 bytes", ValueError,
                 lambda: flash_attention_prefix_quant(q2[:1], k_odd, k_odd, ks[:1, :64],
                                                      vs[:1, :64], 64))
    k_bcast = kq[:1, :1].expand(1, 64, H, D)              # token stride 0
    expect_raise("flash_attention_prefix_quant token stride 0", ValueError,
                 lambda: flash_attention_prefix_quant(q2[:1], k_bcast, k_bcast, ks[:1, :64],
                                                      vs[:1, :64], 64))
    expect_raise("flash_attention_prefix_quant empty cache", ValueError,
                 lambda: flash_attention_prefix_quant(q2[:1], kq[:1, :0], vq[:1, :0],
                                                      ks[:1, :0], vs[:1, :0], 0))
    # the same rule for the bf16 and e4m3 instantiations
    for kind, cache in (("bf16", k8[:1].to(torch.bfloat16)), ("e4m3", k8[:1])):
        k_bcast = cache[:, :1].expand(1, 64, H, D)        # token stride 0
        expect_raise(f"flash_attention_prefix {kind} token stride 0", ValueError,
                     lambda: flash_attention_prefix(q2[:1], k_bcast, k_bcast, 64))
        expect_raise(f"flash_attention_prefix {kind} empty cache", ValueError,
                     lambda: flash_attention_prefix(q2[:1], cache[:, :0], cache[:, :0], 0))
        # a token stride off the 16-byte grid: 1540 bf16 (3080 bytes), 1544 e4m3
        pad = 4 if kind == "bf16" else 8
        wide = torch.zeros(1, 64, H * D + pad, dtype=cache.dtype, device=dev)
        k_odd = wide[..., :H * D].view(1, 64, H, D)
        expect_raise(f"flash_attention_prefix {kind} token stride "
                     f"{(H * D + pad) * cache.element_size()} bytes", ValueError,
                     lambda: flash_attention_prefix(q2[:1], k_odd, k_odd, 64))
        del cache, k_bcast, wide, k_odd
    if failed:
        raise AssertionError(f"kv kernel cases {failed} disagree with the plain versions")
    return entries


def plain_quant_attention(q, k, v, k_scale, v_scale, kv_mask=None, scale=None):
    """The int8-KV mask wrapper with the plain path in place of the kernel:
    dequantize to bf16, then attend (the plain flash version)."""
    return plain_flash_attention(q, dequantize(k, k_scale, q.dtype),
                                 dequantize(v, v_scale, q.dtype), kv_mask, scale)


def kv_path_config(path: str) -> EngineConfig:
    """The three paths of this slice, Wan2.1-T2V-1.3B at full width and
    depth: "int8_b2" W8A8 + int8 KV at B=2, rerun, global 21-frame window
    (bench.py:237-250); "window" W8A8 + int8 KV through a 12-frame rolling
    window with 1 sink frame, last_step (bench.py:94-108); "fp8" bf16
    weights + the e4m3 KV cache at B=1, rerun (JAX semi_ar.py:139-146)."""
    blocks = WINDOW_BLOCKS if path == "window" else 2
    cfg = main_path_config(blocks, w8a8=path != "fp8")
    q = cfg.quant
    q.enabled, q.quantize_kv_cache = True, True
    q.kv_cache_dtype = "fp8" if path == "fp8" else "int8"
    if path == "int8_b2":
        cfg.runtime.batch_size = 2
    if path == "window":
        cfg.model.local_attn_size, cfg.model.sink_size = WINDOW_FRAMES, SINK_FRAMES
        cfg.runtime.context_mode = "last_step"
    return cfg


def kv_path_setup(dev: torch.device, cfg: EngineConfig, w8a8: bool):
    """main_path_setup for batch B: the seed-0 weights (quantized for
    W8A8), text K/V of B random prompts, noise [B, F, H, W, C]."""
    m, r = cfg.model, cfg.runtime
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(m, g, device=dev, dtype=torch.bfloat16)
    if w8a8:
        params = quantize_params(params, cfg.quant)
    gen = SemiARGenerator(cfg, params, dtype=torch.bfloat16, device=dev)
    b = r.batch_size
    context = torch.randn(b, m.text_len, m.text_dim, generator=g,
                          device=dev).to(torch.bfloat16)
    xattn = gen.encode_text_context(context)
    noise = torch.randn(b, r.num_frames, r.latent_height, r.latent_width,
                        r.latent_channels, generator=g, device=dev).to(torch.bfloat16)
    return gen, xattn, noise, g


def kv_path_phase(dev: torch.device, path: str) -> tuple:
    """Drive one path: launches per block, the output, the cache (and the
    ring's wrap), then one layer and one forward at the last block with the
    path's attention kernel against its plain version. Returns (launches of
    every kernel over the path's generation, latents)."""
    t0 = time.perf_counter()
    cfg = kv_path_config(path)
    m, r = cfg.model, cfg.runtime
    fpb, b = m.num_frame_per_block, r.batch_size
    blocks = r.num_frames // fpb
    gen, xattn, noise, g = kv_path_setup(dev, cfg, w8a8=path != "fp8")
    spec = gen.statics.spec
    torch.cuda.synchronize()
    print(f"{path} setup: {time.perf_counter() - t0:.3f} s; cache {spec.max_tokens} "
          f"slots, ring {spec.ring}, sink {spec.sink_tokens}, "
          f"{'int8 + scales' if spec.quantized else spec.dtype}, batch {b}", flush=True)
    kernel = "flash_attention_prefix_fp8" if path == "fp8" else "flash_attention_prefix_quant"
    forwards = len(gen.denoising_steps) + (1 if r.context_mode == "rerun" else 0)
    spans, marks, per_block, snaps = [], [time.perf_counter()], [], {}
    real_quant = attention_mod.flash_attention_quant

    def spy_quant(q, k, v, k_scale, v_scale, kv_mask=None, scale=None):
        spans.append((k.shape[1], kv_mask.sum(-1)))
        return real_quant(q, k, v, k_scale, v_scale, kv_mask=kv_mask, scale=scale)

    def on_block(x0, bi):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_block.append(count_diff(all_counts(), prev[0]))
        prev[0] = all_counts()
        print(f"{path} block {bi}: {marks[-1] - marks[-2]:.3f} s, launches "
              f"{per_block[-1]}", flush=True)
        if path == "window" and bi in (blocks - 2, blocks - 1):
            snaps[bi] = gen_cache[0].k_scale[:, :, :, :].clone()

    reset_counts()
    prev = [all_counts()]
    gen_cache = [gen.init_cache()]
    with mock.patch.object(attention_mod, "flash_attention_quant", spy_quant):
        latents, cache = gen.generate(noise, xattn, generator=g, cache=gen_cache[0],
                                      block_callback=on_block)
    torch.cuda.synchronize()
    launches = all_counts()
    n = m.num_layers * forwards
    for bi, got in enumerate(per_block):
        if got.get(kernel) != n or got.get("flash_attention_prefix", 0) \
                or (path != "fp8" and got.get("flash_attention_prefix_fp8", 0)) \
                or (path == "fp8" and got.get("flash_attention_prefix_quant", 0)):
            raise AssertionError(f"{path} block {bi}: launches {got}, want {n} of {kernel} "
                                 "and no other attention kernel")
    if path != "fp8":
        # the int8 KV writes quantize through the act-quant kernel: 2 a layer-forward
        want_q = 3 * n + 2 * n
        if any(got.get("quantize_rows_int8") != want_q for got in per_block):
            raise AssertionError(f"{path}: act-quant launches per block "
                                 f"{[p.get('quantize_rows_int8') for p in per_block]}, "
                                 f"want {want_q} (activations + K/V writes)")
    shape = (b, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError(f"{path} latents {tuple(latents.shape)} (want {shape}) "
                             "or not finite")
    end = min(r.num_frames * gen.frame_seq, spec.max_tokens)
    for name in ("k", "v"):
        for layer in getattr(cache, name):  # one layer at a time: float32 copies
            buf = layer.float()
            if not torch.isfinite(buf).all():
                raise AssertionError(f"{path}: cache {name} not finite")
            if not (buf[:, :end].abs().amax(dim=(-1, -2)) > 0).all():
                raise AssertionError(f"{path}: a written cache slot of {name} is zero")
            if buf[:, end:].any():
                raise AssertionError(f"{path}: a cache slot past the span was written")
        if spec.quantized:
            sc = getattr(cache, name + "_scale")
            if not (torch.isfinite(sc).all() and (sc[:, :, :end] > 0).all()):
                raise AssertionError(f"{path}: a {name} scale is not finite and positive")
    if path == "window":
        keys = max(k for k, _ in spans)
        live = torch.stack([s.max() for _, s in spans]).max().item()
        if keys != WINDOW_KEYS or live > WINDOW_KEYS:
            raise AssertionError(f"window: the kernel saw {keys} slots, {live} live keys "
                                 f"(at most {WINDOW_KEYS})")
        # the last block (frames 12-14) wrapped into ring slots of frames 1-3;
        # the sink frame and frames 4-11 kept what the block before left
        fs = gen.frame_seq
        before, after = snaps[blocks - 2], snaps[blocks - 1]
        wrapped = slice(SINK_FRAMES * fs, (SINK_FRAMES + fpb) * fs)
        if not ((after[:, :, wrapped] != before[:, :, wrapped]).any(-1).all()
                and torch.equal(after[:, :, :fs], before[:, :, :fs])
                and torch.equal(after[:, :, wrapped.stop:], before[:, :, wrapped.stop:])):
            raise AssertionError("window: the last block did not wrap into slots "
                                 f"[{wrapped.start}, {wrapped.stop}) alone")
        print(f"window: {len(spans)} kernel calls over {keys} slots, at most {live} live "
              f"keys; the last block overwrote ring slots [{wrapped.start}, "
              f"{wrapped.stop}), the sink frame and the rest kept", flush=True)
    secs = [marks[i + 1] - marks[i] for i in range(len(per_block))]
    print(f"{path} main path: latents {tuple(latents.shape)} finite, |x0| max "
          f"{latents.float().abs().max().item():.3f}, s/block "
          f"{', '.join(f'{x:.3f}' for x in secs)}, launches {launches}", flush=True)

    # one layer, then one forward, at the last block's first denoise step
    f0 = r.num_frames - fpb
    start = f0 * gen.frame_seq
    geo = gen.statics.geo
    x_blk = latents[:, f0:]
    t = torch.full((b, fpb), gen.denoising_steps[0], device=dev)
    if path == "fp8":
        plain = mock.patch.object(attention_mod, "flash_attention", plain_flash_attention)
    else:
        plain = mock.patch.object(attention_mod, "flash_attention_quant",
                                  plain_quant_attention)
    with torch.inference_mode():
        tokens = patch_embed(gen.params, m, x_blk)
        _, e0 = time_embeddings(gen.params, m, t)
        angles = rope_angles(gen.rope_tables, fpb, geo.grid_h, geo.grid_w, f0)
        mask = valid_mask(spec, start + geo.tokens, device=dev)
        blk = layer_params(gen.params["blocks"], 0)
        fields = [f for f in cache if f is not None]
        ys, flows = [], []
        for use_plain in (False, True):
            before = all_counts()
            with plain if use_plain else contextlib.nullcontext():
                lc = tuple(f[0].clone() for f in fields)
                y, _ = block_forward(blk, m, spec, tokens, e0, angles, lc, xattn.k[0],
                                     xattn.v[0], start, mask)
                flow, _ = dit_forward_inference(gen.params, gen.statics, gen.rope_tables,
                                                x_blk, t, xattn, cache, start)
            moved = count_diff(all_counts(), before).get(kernel, 0)
            if moved != (0 if use_plain else 1 + m.num_layers):
                raise AssertionError(f"{path}: {kernel} launched {moved} times in the "
                                     f"{'plain' if use_plain else 'kernel'} run")
            ys.append(y)
            flows.append(flow)
        layer_err = rel_err(ys[0] - tokens, ys[1] - tokens)
        fwd_err = rel_err(flows[0], flows[1])
    print(f"{path} block_forward {kernel} vs plain: update rel err {layer_err:.3e} "
          f"(tol {LAYER_RTOL:g}); dit_forward_inference flow rel err {fwd_err:.3e} "
          f"(tol {FORWARD_RTOL:g})", flush=True)
    if not (layer_err <= LAYER_RTOL and fwd_err <= FORWARD_RTOL):
        raise AssertionError(f"the {path} path with its kernel disagrees with the plain one")
    del gen, cache, gen_cache, xattn, snaps
    torch.cuda.empty_cache()
    phase(f"{path} main", t0)
    return launches, latents


def conv_times(tin, h, w, cin, cout, kt, peak, x_bytes=2) -> tuple:
    """(ops_ms, bytes_ms) of one conv: its operations at `peak`, its input
    (x_bytes an element: bf16 2, int8 codes 1) and weights (the same width),
    bf16 output and f32 bias at the memory rate."""
    t_out = tin - kt + 1
    ops = 2.0 * t_out * h * w * cout * kt * 9 * cin
    nbytes = (x_bytes * (tin * h * w * cin + kt * 9 * cin * cout) + 2.0 * t_out * h * w * cout
              + 4 * cout)
    return ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


def act_quant_bytes_ms(n: int) -> float:
    """The activation quantization's bound: x read once (bf16), the codes
    written once (s8), at the memory rate (the kernel pair reads x twice)."""
    return 3.0 * n / PEAK_BYTES_PER_S * 1e3


def cudnn_operands(x, w, b):
    """x [Tin, H, W, C] and w [kt, 3, 3, Cin, Cout] as cuDNN's channels-last
    NCDHW operands."""
    xt = x.permute(3, 0, 1, 2)[None]
    wt = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    return xt, wt, b


def vae_kernel_phase(dev: torch.device) -> list:
    """B6 and B7 against their plain versions at every decode and encode conv
    class (B7 and the activation quantization bit-equal; the encoder's RGB
    input conv, Cin 3, through the wrappers' channel padding), then timed
    beside the bound and cuDNN (F.conv3d, bf16): B7's conv kernel on its
    codes and the quantization kernel each on its own, and the W8A8 wrapper
    (both). Sums a decode chunk go to the kernels line; sums an encode chunk
    are printed."""
    g = torch.Generator(device=dev).manual_seed(4)
    names = ("halo_conv3d", "halo_conv3d_w8a8", "quantize_conv_act")
    all_sums = {work: {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0,
                               bytes_ms=0.0, err=0.0) for k in names}
                for work in ("decode", "encode")}
    all_wrapper_ms = {"decode": 0.0, "encode": 0.0}
    failed = []
    before = all_counts()
    for work, (name, tin, h, w, cin, cout, kt, n_halo, n_w8a8) in (
            [("decode", c) for c in VAE_CONVS] + [("encode", c) for c in ENCODE_CONVS]):
        sums = all_sums[work]
        x = torch.randn(tin, h, w, cin, generator=g, device=dev).to(torch.bfloat16)
        bound = 1.0 / (kt * 9 * cin) ** 0.5
        wt = ((torch.rand(kt, 3, 3, cin, cout, generator=g, device=dev) * 2 - 1)
              * bound).to(torch.bfloat16)
        b = ((torch.rand(cout, generator=g, device=dev) * 2 - 1) * bound).to(torch.bfloat16)
        xt, wc, _ = cudnn_operands(x, wt, b)
        lib = time_ms(lambda: F.conv3d(xt, wc, b, padding=(0, 1, 1)))
        shape = f"{name} [{tin},{h},{w},{cin}] kt {kt} -> {cout}"
        for kname, kern, plain, calls, peak in (
                ("halo_conv3d", halo_conv3d, halo_conv3d_reference, n_halo, PEAK_BF16_FLOPS),
                ("halo_conv3d_w8a8", halo_conv3d_w8a8, halo_conv3d_w8a8_reference, n_w8a8,
                 PEAK_INT8_OPS)):
            if kname == "halo_conv3d" and kt != 3:
                continue  # the bf16 gate takes 3x3x3 convs only
            int8 = kname == "halo_conv3d_w8a8"
            plan = tile_plan(tin, h, w, halo_mod.padded_cin(cin, 16 if int8 else 8), cout,
                             kt, int8)
            # as the decode calls it: on the weight operand CausalVAE packs once
            pk = pack_weight(wt, w8a8=int8)
            out = kern(x, wt, b, packed=pk)
            torch.cuda.synchronize()
            ref = plain(x, wt, b)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if not int8:
                rms = ref.float().pow(2).mean().sqrt()
                share = (diff / (CONV_TOL * (ref.float().abs() + rms / 16))).max().item()
                ok = share <= 1 and torch.isfinite(out).all().item()
                detail = (f"max |diff|/({CONV_TOL:g}*(|ref|+rms/16)) {share:.3f} (tol 1), "
                          f"rms(ref) {rms.item():.3e}")
            else:
                ok = err == 0 and torch.isfinite(out).all().item()
                detail = "(tol 0)"
            del diff, ref, out
            plain_ms = time_ms(lambda: plain(x, wt, b), iters=2, warmup=1)
            if int8:
                # the activation quantization kernel on its own: codes and s_x
                # bit-equal to the plain version's, then timed
                q, s_x = quantize_conv_act(x)
                q_ref, s_ref = _quantize_conv_act(x)
                q_ok = torch.equal(q, q_ref) and torch.equal(s_x, s_ref)
                print(f"vae case quantize_conv_act {shape}: codes equal "
                      f"{torch.equal(q, q_ref)}, s_x {s_x.item():.9e} equal "
                      f"{torch.equal(s_x, s_ref)} (tol 0) {'ok' if q_ok else 'FAIL'}",
                      flush=True)
                if not q_ok:
                    failed.append(f"quantize_conv_act {name}")
                del q_ref, s_ref
                q_ms = time_ms(lambda: quantize_conv_act(x))
                q_plain_ms = time_ms(lambda: _quantize_conv_act(x), iters=2, warmup=1)
                q_bytes_ms = act_quant_bytes_ms(x.numel())
                print(f"vae time quantize_conv_act {shape}: {q_ms:.4f} ms, bound "
                      f"{q_bytes_ms:.4f} ms (bytes), plain {q_plain_ms:.4f} ms; {calls} a "
                      f"chunk", flush=True)
                acc = sums["quantize_conv_act"]
                for key, v in (("ms", q_ms), ("plain_ms", q_plain_ms),
                               ("bytes_ms", q_bytes_ms)):
                    acc[key] += calls * v
                # the conv kernel on the codes, and the wrapper (both kernels)
                # (the codes padded to the operand's channels, as the wrapper pads x)
                qk = F.pad(q, (0, pk.wk.shape[-1] - cin))
                ms = time_ms(lambda: halo_mod._launch(qk, pk.wk, b, s_x, pk.s_w, kt, cout, True))
                del qk
                w_ms = time_ms(lambda: kern(x, wt, b, packed=pk))
                all_wrapper_ms[work] += calls * w_ms
                del q, s_x
                extra = f", the wrapper (quantization + conv) {w_ms:.4f} ms"
            else:
                ms = time_ms(lambda: kern(x, wt, b, packed=pk))
                extra = ""
            ops_ms, bytes_ms = conv_times(tin, h, w, cin, cout, kt, peak, 1 if int8 else 2)
            t_out = tin - kt + 1
            print(f"vae case {kname} {shape}: max_abs {err:.3e} {detail} "
                  f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms "
                  f"({2 * t_out * h * w * cout * kt * 9 * cin / ms / 1e9:.1f} TOP/s), bound "
                  f"{max(ops_ms, bytes_ms):.4f} ms, plain {plain_ms:.4f} ms, cudnn bf16 "
                  f"{lib:.4f} ms{extra}; tile n {plan.n_tile} x {plan.rows} rows x 16, "
                  f"{plan.tiles} tiles, L2->SM {plan.halo_bytes / 1e9:.3f} GB halos + "
                  f"{plan.weight_bytes / 1e9:.3f} GB weights; {calls} a chunk", flush=True)
            if not ok:
                failed.append(f"{kname} {name}")
            acc = sums[kname]
            acc["err"] = max(acc["err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                           ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                acc[key] += calls * v
        del x, wt, xt, wc, pk
    # the wrappers refuse what their kernels cannot take
    x = torch.randn(3, 16, 16, 96, device=dev)
    wt = torch.randn(3, 3, 3, 96, 96, device=dev)
    b = torch.zeros(96, device=dev)
    expect_raise("halo_conv3d float32", TypeError, lambda: halo_conv3d(x, wt, b))
    # Cin 24 is no multiple of 16: the W8A8 wrapper pads it to 32 (it refused
    # it before the padding), bit-equal to the plain version; an operand
    # packed for another Cin is refused
    x24, w24 = x[..., :24].contiguous().to(torch.bfloat16), wt[:, :, :, :24]
    cin24_ok = torch.equal(halo_conv3d_w8a8(x24, w24, b),
                           halo_conv3d_w8a8_reference(x24, w24, b))
    print(f"vae case halo_conv3d_w8a8 Cin 24 (padded to 32): bit-equal {cin24_ok} "
          f"(tol 0) {'ok' if cin24_ok else 'FAIL'}", flush=True)
    if not cin24_ok:
        failed.append("halo_conv3d_w8a8 Cin 24")
    expect_raise("halo_conv3d_w8a8 operand of another Cin", ValueError, lambda: halo_conv3d_w8a8(
        x24, w24, b, packed=pack_weight(wt[:, :, :, :40], w8a8=True)))
    expect_raise("halo_conv3d strided x", ValueError, lambda: halo_conv3d(
        x.to(torch.bfloat16)[:, :, ::2], wt, b))
    expect_raise("quantize_conv_act float32", TypeError, lambda: quantize_conv_act(x))
    restore_counts(before)
    if failed:
        raise AssertionError(f"VAE conv cases {failed} disagree with the plain versions")
    entries = []
    sums = all_sums["decode"]
    for kname in names:
        acc = all_sums["encode"][kname]
        bound_ms, bound_by = bound_of(acc["ops_ms"], acc["bytes_ms"])
        lib = "-" if kname == "quantize_conv_act" else f"{acc['library_ms']:.4f}"
        print(f"vae per encode chunk {kname}: {acc['ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {acc['plain_ms']:.4f} ms, cudnn {lib} ms, "
              f"max_abs {acc['err']:.3e}", flush=True)
    print(f"vae per encode chunk W8A8 wrapper (quantization + conv kernel): "
          f"{all_wrapper_ms['encode']:.4f} ms", flush=True)
    for kname, replaces, impl in (
            ("halo_conv3d", "inferix_tpu/ops/halo_conv.py:59", "halo"),
            ("halo_conv3d_w8a8", "inferix_tpu/ops/halo_conv.py:113", "halo_w8a8"),
            ("quantize_conv_act", "inferix_tpu/ops/halo_conv.py:183", "halo_w8a8")):
        acc = sums[kname]
        bound_ms, bound_by = bound_of(acc["ops_ms"], acc["bytes_ms"])
        lib_ms = acc["library_ms"] if kname != "quantize_conv_act" else None
        print(f"vae per chunk {kname}: {acc['ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {acc['plain_ms']:.4f} ms, cudnn "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms", flush=True)
        entries.append({
            "name": kname, "route": "cuda", "source": "inferix_tpu_torch/csrc/halo_conv.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": acc["err"], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "work": "one decode chunk of 3 latent frames (not the first), "
                    f"{DECODE_LAUNCHES[impl][kname]} "
                    + ("quantizations (XLA ops on the TPU, not a Pallas site)"
                       if kname == "quantize_conv_act" else "convs")})
    print(f"vae per chunk W8A8 wrapper (quantization + conv kernel): "
          f"{all_wrapper_ms['decode']:.4f} ms", flush=True)
    return entries


def vae_params(dev: torch.device, cfg: VAEConfig):
    """The VAE's weights from seed 5. The init's attention output
    projections are zero (the reference's training init); they are drawn
    here, the decoder's and then the encoder's, so the attention blocks
    change the pixels and the latents."""
    g = torch.Generator(device=dev).manual_seed(5)
    params = init_vae_params(cfg, g, device=dev)
    for part in ("decoder", "encoder"):
        proj = params[part]["middle"]["attn"]["proj"]
        c = proj["w"].shape[-2]
        proj["w"].uniform_(-c ** -0.5, c ** -0.5, generator=g)
    return params


def checked_w8a8_conv(worst: list):
    """halo_conv3d_w8a8 with each call held against the float32 conv of its
    own input (W8A8_CONV_BOUND of the output scale); the worst share goes to
    worst[0]."""
    real_w8a8 = vae_mod.halo_conv3d_w8a8

    def checked(x, w, b, packed=None):
        out = real_w8a8(x, w, b, packed=packed)
        ref = F.conv3d(x.permute(3, 0, 1, 2)[None].float(),
                       w.float().permute(4, 3, 0, 1, 2), b.float(), padding=(0, 1, 1))
        ref = ref[0].permute(1, 2, 3, 0)
        share = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        worst[0] = max(worst[0], share)
        if share > W8A8_CONV_BOUND:
            raise AssertionError(f"a W8A8 conv {tuple(x.shape)} x {tuple(w.shape)} is off "
                                 f"its float32 conv by {share:.3e} of the output scale "
                                 f"(bound {W8A8_CONV_BOUND:g})")
        return out

    return checked


def vae_decode_phase(dev: torch.device, latents: torch.Tensor) -> dict:
    """Decode the fp8 path's 6 latent frames in two 3-frame chunks with each
    conv impl; launches per chunk; pixels checked; halo against cuDNN; every
    W8A8 conv against the float32 conv of its own input."""
    t0 = time.perf_counter()
    cfg = VAEConfig()
    params = vae_params(dev, cfg)
    if latents.shape[1] < LATENT_FRAMES:
        raise AssertionError(f"the decode needs {LATENT_FRAMES} latent frames, got "
                             f"{latents.shape[1]}")
    lat = latents[:1, :LATENT_FRAMES]
    w8a8_worst, videos, launches = [0.0], {}, {}
    checked_w8a8 = checked_w8a8_conv(w8a8_worst)

    want = DECODE_LAUNCHES
    # the W8A8 decode runs twice: timed, then with every conv checked (the
    # checks' float32 convs would dominate its seconds per chunk)
    for impl, checked in (("xla", False), ("halo", False), ("halo_w8a8", False),
                          ("halo_w8a8", True)):
        vae = CausalVAE(cfg, params, dtype=torch.bfloat16, device=dev, conv_impl=impl)
        reset_counts()
        cache, chunks, per_chunk, secs = None, [], [], []
        patch = (mock.patch.object(vae_mod, "halo_conv3d_w8a8", checked_w8a8)
                 if checked else contextlib.nullcontext())
        with patch:
            for i in range(0, LATENT_FRAMES, 3):
                before = all_counts()
                t1 = time.perf_counter()
                out, cache = vae.decode_chunk(lat[:, i:i + 3], cache, first=(i == 0))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
                per_chunk.append(count_diff(all_counts(), before))
                chunks.append(out)
        video = torch.clamp(torch.cat(chunks, dim=1), -1.0, 1.0)
        label = impl + (" (each conv checked)" if checked else "")
        print(f"vae decode {label}: s/chunk {', '.join(f'{x:.3f}' for x in secs)}, "
              f"launches per chunk {per_chunk}", flush=True)
        if per_chunk != [want[impl]] * 2:
            raise AssertionError(f"vae {impl}: launches per chunk {per_chunk}, "
                                 f"want {want[impl]} in each")
        if checked:
            if not torch.equal(video, videos[impl]):
                raise AssertionError("the checked W8A8 decode differs from the timed one")
            continue
        launches[impl] = all_counts()
        shape = (1, 1 + cfg.temporal_factor * (LATENT_FRAMES - 1),
                 cfg.spatial_factor * lat.shape[2], cfg.spatial_factor * lat.shape[3], 3)
        if tuple(video.shape) != shape or not torch.isfinite(video).all() \
                or video.abs().max().item() > 1:
            raise AssertionError(f"vae {impl}: pixels {tuple(video.shape)} (want {shape}), "
                                 "not finite or outside [-1, 1]")
        videos[impl] = video
        del vae, cache, chunks
    halo_err = rel_err(videos["halo"], videos["xla"])
    w8a8_err = rel_err(videos["halo_w8a8"], videos["xla"])
    print(f"vae decode: pixels {tuple(videos['xla'].shape)} finite in [-1, 1], std "
          f"{videos['xla'].float().std().item():.3f}; halo vs xla rel err {halo_err:.3e} "
          f"(tol {HALO_DECODE_RTOL:g}); halo_w8a8 vs xla rel err {w8a8_err:.3e} "
          f"(information); worst W8A8 conv vs its float32 conv {w8a8_worst[0]:.3e} of "
          f"the output scale (bound {W8A8_CONV_BOUND:g})", flush=True)
    if halo_err > HALO_DECODE_RTOL:
        raise AssertionError("the halo decode disagrees with the cuDNN decode")
    del videos
    torch.cuda.empty_cache()
    phase("vae decode", t0)
    return launches

def vae_encode_phase(dev: torch.device) -> tuple:
    """Encode 9 seeded pixel frames [1, 9, 480, 832, 3] in [-1, 1] to latents
    [1, 3, 60, 104, 16] with each conv impl (bf16): kernel launches a chunk
    (22 B6; 22 B7 and 22 quantizations), latents finite, halo against xla,
    every W8A8 conv against the float32 conv of its own input, seconds a
    chunk. Returns (launches by impl, the halo latents)."""
    t0 = time.perf_counter()
    cfg = VAEConfig()
    params = vae_params(dev, cfg)
    g = torch.Generator(device=dev).manual_seed(6)
    video = (torch.rand(1, ENCODE_FRAMES, 480, 832, 3, generator=g, device=dev) * 2
             - 1).to(torch.bfloat16)
    w8a8_worst, lats, launches = [0.0], {}, {}
    chunks = [(0, 1)] + [(i, i + 4) for i in range(1, ENCODE_FRAMES, 4)]
    for impl, checked in (("xla", False), ("halo", False), ("halo_w8a8", False),
                          ("halo_w8a8", True)):
        vae = CausalVAE(cfg, params, dtype=torch.bfloat16, device=dev, conv_impl=impl)
        reset_counts()
        cache, outs, per_chunk, secs = None, [], [], []
        patch = (mock.patch.object(vae_mod, "halo_conv3d_w8a8",
                                   checked_w8a8_conv(w8a8_worst))
                 if checked else contextlib.nullcontext())
        with patch:
            for i, (a, b) in enumerate(chunks):
                before = all_counts()
                t1 = time.perf_counter()
                out, cache = vae.encode_chunk(video[:, a:b], cache, first=(i == 0))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
                per_chunk.append(count_diff(all_counts(), before))
                outs.append(out)
        lat = torch.cat(outs, dim=1)
        label = impl + (" (each conv checked)" if checked else "")
        print(f"vae encode {label}: s/chunk {', '.join(f'{x:.3f}' for x in secs)}, "
              f"launches per chunk {per_chunk}", flush=True)
        if per_chunk != [ENCODE_LAUNCHES[impl]] * len(chunks):
            raise AssertionError(f"vae encode {impl}: launches per chunk {per_chunk}, "
                                 f"want {ENCODE_LAUNCHES[impl]} in each")
        if checked:
            if not torch.equal(lat, lats[impl]):
                raise AssertionError("the checked W8A8 encode differs from the timed one")
            continue
        launches[impl] = all_counts()
        if impl == "halo" and not torch.equal(lat, vae.encode(video)):
            raise AssertionError("vae encode: encode() differs from its chunks")
        shape = (1, 1 + (ENCODE_FRAMES - 1) // cfg.temporal_factor, 60, 104, cfg.z_dim)
        if tuple(lat.shape) != shape or not torch.isfinite(lat).all():
            raise AssertionError(f"vae encode {impl}: latents {tuple(lat.shape)} (want "
                                 f"{shape}) or not finite")
        lats[impl] = lat
        del vae, cache, outs
    expect_raise("encode of 8 frames", ValueError,
                 lambda: CausalVAE(cfg, params, dtype=torch.bfloat16, device=dev)
                 .encode(video[:, :8]))
    halo_err = rel_err(lats["halo"], lats["xla"])
    w8a8_err = rel_err(lats["halo_w8a8"], lats["xla"])
    print(f"vae encode: latents {tuple(lats['xla'].shape)} finite, std "
          f"{lats['xla'].float().std().item():.3f}; halo vs xla rel err {halo_err:.3e} "
          f"(tol {HALO_DECODE_RTOL:g}); halo_w8a8 vs xla rel err {w8a8_err:.3e} "
          f"(information); worst W8A8 conv vs its float32 conv {w8a8_worst[0]:.3e} of "
          f"the output scale (bound {W8A8_CONV_BOUND:g})", flush=True)
    if halo_err > HALO_DECODE_RTOL:
        raise AssertionError("the halo encode disagrees with the cuDNN encode")
    del video
    torch.cuda.empty_cache()
    phase("vae encode", t0)
    return launches, lats["halo"]


# ---------------------------------------------------------------------------
# The Self-Forcing pipeline: text features in, pixels out, through the entry
# points a user calls (this slice's main path)
# ---------------------------------------------------------------------------

SEGMENT_FRAMES, OVERLAP_FRAMES = 9, 3  # streaming segments: 9 + 6 new frames
I2V_FRAMES = 18                         # after a 3-frame prefix: the 21-frame cache


def pipeline_config(quantize_kv: bool = False) -> EngineConfig:
    """Wan2.1-T2V-1.3B at full width and depth, 480x832, a 21-frame cache,
    21 frames, W8A8 linears (`bench.py:229-234`), the bf16 VAE on the halo
    conv kernel, AUTO streaming over 9-frame segments with a 3-frame overlap;
    quantize_kv: the int8 KV cache too (and no VAE: no decode)."""
    cfg = main_path_config(7, w8a8=True)
    r = cfg.runtime
    r.vae_conv_impl = "halo"
    r.frames_per_segment, r.overlap_frames = SEGMENT_FRAMES, OVERLAP_FRAMES
    r.streaming_mode = StreamingMode.AUTO
    if quantize_kv:
        cfg.quant.quantize_kv_cache = True
        r.decode_mode = DecodeMode.NO_DECODE
    return cfg


class StandInTextEncoder:
    """A seeded stand-in for the UMT5 text encoder: bf16 features [1, 512,
    4096] drawn from a seed taken from the prompt. Keeps the prompts it was
    called with."""

    def __init__(self, dev: torch.device):
        self.dev, self.prompts = dev, []

    def __call__(self, prompts):
        self.prompts.append(prompts[0])
        g = torch.Generator(device=self.dev).manual_seed(zlib.crc32(prompts[0].encode()))
        return torch.randn(1, TEXT, 4096, generator=g, device=self.dev).to(torch.bfloat16)


def add_counts(total: dict, diff: dict) -> None:
    for k, v in diff.items():
        total[k] = total.get(k, 0) + v


def w8a8_block_launches(gen, kv_int8: bool) -> dict:
    """A block's launches on the W8A8 path (rerun): per layer-forward 6 int8
    GEMMs, 3 act-quants (+2 for the int8 K/V write), 2 LN+modulate, 1
    LN+affine, 1 attention kernel."""
    n = gen.cfg.model.num_layers * (len(gen.denoising_steps) + 1)
    attn = "flash_attention_prefix_quant" if kv_int8 else "flash_attention_prefix"
    return {"int8_matmul": 6 * n, "quantize_rows_int8": (5 if kv_int8 else 3) * n,
            "adaln": 2 * n, "ln": n, attn: n}


def pipeline_phase(dev: torch.device, smi: str, prefix: torch.Tensor) -> dict:
    """SelfForcingPipeline end to end: run_text_to_video (AFTER_ALL, 21
    frames), run_streaming_generation (2 segments, TRUE_STREAMING by AUTO,
    then DEFERRED_DECODE), run_interactive_generation (a prompt update
    before segment 1, a stop at its block 1), then with the int8 KV cache
    run_image_to_video (18 frames after the encoded 3-frame prefix) and the
    KV manager. Returns the launches of every kernel over the pipeline's
    own calls (the checks' reference runs excluded)."""
    t0 = time.perf_counter()
    cfg = pipeline_config()
    m, r = cfg.model, cfg.runtime
    text = StandInTextEncoder(dev)
    pipe = SelfForcingPipeline(cfg, text_encoder=text, device=dev)
    pipe.setup()
    torch.cuda.synchronize()
    print(f"pipeline setup (weights drawn from runtime.seed and quantized, the bf16 "
          f"halo VAE packed): {time.perf_counter() - t0:.3f} s", flush=True)
    gen, vae = pipe.generator, pipe.vae
    fpb = m.num_frame_per_block
    path = {}

    # --- run_text_to_video, AFTER_ALL, 21 frames
    want_block = w8a8_block_launches(gen, False)
    want_text = {"int8_matmul": 2 * m.num_layers, "quantize_rows_int8": 2 * m.num_layers}
    reset_counts()
    marks, per_block = [all_counts()], []

    def on_block(x0, bi):
        marks.append(all_counts())
        per_block.append(count_diff(marks[-1], marks[-2]))

    t1 = time.perf_counter()
    video, latents = pipe.run_text_to_video(["a red fox"], return_latents=True,
                                            decode_mode=DecodeMode.AFTER_ALL,
                                            block_callback=on_block)
    torch.cuda.synchronize()
    t2v_s = time.perf_counter() - t1
    run = all_counts()
    add_counts(path, count_diff(run, {k: 0 for k in run}))
    blocks = r.num_frames // fpb
    want = [{k: v + want_text.get(k, 0) for k, v in want_block.items()}] \
        + [want_block] * (blocks - 1)
    decode_launches = count_diff(run, marks[-1])
    want_decode = {"halo_conv3d": DECODE_LAUNCHES["halo"]["halo_conv3d"] * -(-r.num_frames // 3)}
    print(f"pipeline t2v launches: block 0 {per_block[0]} (text encode included), "
          f"blocks 1-{blocks - 1} {per_block[1]}, decode {decode_launches}", flush=True)
    if per_block != want or decode_launches != want_decode:
        raise AssertionError(f"pipeline launches per block {per_block}, decode "
                             f"{decode_launches}; want {want}, {want_decode}")
    shape = (1, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    vshape = (1, 1 + 4 * (r.num_frames - 1), 480, 832, 3)
    if (tuple(latents.shape) != shape or tuple(video.shape) != vshape
            or not torch.isfinite(video).all() or video.min() < 0 or video.max() > 1):
        raise AssertionError(f"pipeline: latents {tuple(latents.shape)} (want {shape}), "
                             f"video {tuple(video.shape)} (want {vshape}), or not in [0, 1]")
    # the pipeline adds no arithmetic: the generator on the same draws and
    # text features, and the VAE's decode, give the same bits
    with torch.inference_mode():
        noise, g, renoise = pipe._draw_noise(r.seed, shape)
        ref_lat, _ = gen.generate(noise, pipe._encode_prompts(["a red fox"]),
                                  generator=g, renoise=renoise)
        ref_video = vae.decode(latents) * 0.5 + 0.5
    lat_equal, vid_equal = torch.equal(ref_lat, latents), torch.equal(ref_video, video)
    del noise, ref_lat, ref_video, video
    prof = pipe.profiler.summary()
    block_s = [b["time_ms"] / 1e3 for b in pipe.profiler.blocks]
    stages = {k: v / 1e3 for k, v in prof["stages_ms"].items()}
    print(f"pipeline t2v AFTER_ALL (latents bit-equal to SemiARGenerator.generate "
          f"{lat_equal}, video bit-equal to vae.decode * 0.5 + 0.5 {vid_equal}): "
          f"{t2v_s:.3f} s; profiler s/block {', '.join(f'{x:.3f}' for x in block_s)}, time "
          f"to the first block {prof['time_to_first_block_s']:.3f} s, stages (s) "
          f"{', '.join(f'{k} {v:.3f}' for k, v in stages.items())}; {smi}", flush=True)
    if not (lat_equal and vid_equal):
        raise AssertionError("the pipeline's latents or video differ from the generator's "
                             "and the VAE's")
    if (prof["num_blocks"] != blocks or prof["time_to_first_block_s"] is None
            or set(stages) != {"initialization", "diffusion_generation", "vae_decoding"}):
        raise AssertionError(f"pipeline profiler: {prof['num_blocks']} blocks, stages "
                             f"{sorted(stages)}, ttfb {prof['time_to_first_block_s']}")

    # --- run_streaming_generation, 2 segments, TRUE_STREAMING (AUTO) then
    # DEFERRED_DECODE: 9 frames, then 3 carried + 6 new
    mode = pipe.resolve_streaming_mode()
    print(f"pipeline streaming: AUTO resolves to {mode.value}", flush=True)
    if mode != StreamingMode.TRUE_STREAMING:
        raise AssertionError("AUTO did not resolve to TRUE_STREAMING on the card")
    real_ccb = gen.cache_context_block
    runs = {}
    for smode in (StreamingMode.TRUE_STREAMING, StreamingMode.DEFERRED_DECODE):
        r.streaming_mode = smode
        streamed, marks, ctx_blocks = [], [], []
        gen.cache_context_block = lambda *a, **k: (ctx_blocks.append(a[2].shape[1]),
                                                   real_ccb(*a, **k))[1]
        before = all_counts()
        t1 = time.perf_counter()
        try:
            segs = pipe.run_streaming_generation(
                ["a red fox", "a blue bird"], num_segments=2,
                stream_callback=streamed.append,
                segment_callback=lambda lat, i: marks.append(len(streamed)))
        finally:
            del gen.cache_context_block
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launched = count_diff(all_counts(), before)
        add_counts(path, launched)
        equal = []
        with torch.inference_mode():
            for i, seg in enumerate(segs):
                got = torch.cat(streamed[(marks[i - 1] if i else 0):marks[i]], dim=1)
                equal.append(torch.equal(got, vae.decode(seg) * 0.5 + 0.5))
        runs[smode] = segs
        print(f"pipeline streaming {smode.value}: {secs:.3f} s, new frames per segment "
              f"{[x.shape[1] for x in segs]}, carried frames written by "
              f"cache_context_block {ctx_blocks}, pixel chunks streamed per segment "
              f"{[marks[0], marks[1] - marks[0]]}, bit-equal to vae.decode of each "
              f"segment's new latents {equal}, B6 launches {launched.get('halo_conv3d')}",
              flush=True)
        del streamed
        if ([x.shape[1] for x in segs] != [SEGMENT_FRAMES, SEGMENT_FRAMES - OVERLAP_FRAMES]
                or ctx_blocks != [OVERLAP_FRAMES] or not all(equal)):
            raise AssertionError(f"pipeline streaming {smode.value} disagrees")
    r.streaming_mode = StreamingMode.AUTO
    same = all(torch.equal(a, b) for a, b in zip(*runs.values()))
    print(f"pipeline streaming: DEFERRED_DECODE segments bit-equal to TRUE_STREAMING's "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("the streaming modes generated different latents")
    del runs, segs

    # --- run_interactive_generation, 2 segments: a prompt update queued
    # before segment 1, stop() at its block 1
    holder = {}

    def on_status(st):
        if st.current_segment == 1 and "sent" not in holder:
            holder["session"].submit_input(prompt="a blue bird")
            holder["sent"] = True
        if st.current_segment == 1 and st.current_block == 1:
            holder["session"].stop()

    holder["session"] = session = InteractiveSession(status_callback=on_status)
    before, text.prompts = all_counts(), []
    segs = pipe.run_interactive_generation(session, "a red fox", num_segments=2)
    add_counts(path, count_diff(all_counts(), before))
    frames = [x.shape[1] for x in segs]
    print(f"pipeline interactive: new frames per segment {frames}, prompts "
          f"{text.prompts}, stopped {session.status.is_stopped}, frames generated "
          f"{session.status.frames_generated}", flush=True)
    if (frames != [SEGMENT_FRAMES, fpb] or text.prompts != ["a red fox", "a blue bird"]
            or not session.status.is_stopped or session.status.frames_generated != 12):
        raise AssertionError("the interactive run did not stop or update where asked")
    del segs, pipe, gen, vae, latents
    torch.cuda.empty_cache()

    # --- run_image_to_video with the int8 KV cache: 18 frames after the
    # encode phase's 3-frame latent
    pipe = SelfForcingPipeline(pipeline_config(quantize_kv=True), text_encoder=text,
                               device=dev)
    pipe.setup()
    gen = pipe.generator
    want_block = w8a8_block_launches(gen, True)
    forwards = len(gen.denoising_steps) + 1
    ctx = {k: v // forwards for k, v in want_block.items()}  # the prefix's one forward
    before = all_counts()
    marks, per_block = [before], []
    t1 = time.perf_counter()
    out = pipe.run_image_to_video(["a red fox"], prefix, num_frames=I2V_FRAMES,
                                  block_callback=on_block)
    torch.cuda.synchronize()
    i2v_s = time.perf_counter() - t1
    add_counts(path, count_diff(all_counts(), before))
    first = {k: want_block.get(k, 0) + ctx.get(k, 0) + want_text.get(k, 0)
             for k in want_block}
    want = [first] + [want_block] * (I2V_FRAMES // fpb - 1)
    begins = torch.equal(out[:, :prefix.shape[1]], prefix)
    print(f"pipeline i2v (int8 KV): {i2v_s:.3f} s, latents {tuple(out.shape)} begin with "
          f"the prefix {begins}, launches block 0 {per_block[0]} (prefix forward and text "
          f"encode included), then {per_block[1]}; profiler s/block "
          f"{', '.join(f'{b['time_ms'] / 1e3:.3f}' for b in pipe.profiler.blocks)}; {smi}",
          flush=True)
    if per_block != want or not begins or out.shape[1] != prefix.shape[1] + I2V_FRAMES \
            or not torch.isfinite(out).all():
        raise AssertionError(f"pipeline i2v: launches {per_block} (want {want}), begins "
                             f"with the prefix {begins}, {tuple(out.shape)}")
    del out

    # --- the KV manager over the int8 cache: set_range / get_range against
    # the act-quant plain version, offload / restore, device_bytes, clear
    mgr = pipe.kv_manager
    req = KVCacheRequest("check")
    slot = mgr.allocate_slots(req)
    g = torch.Generator(device=dev).manual_seed(7)
    kv = [torch.randn(SQ, H, D, generator=g, device=dev).to(torch.bfloat16) for _ in "kv"]
    before = all_counts()
    mgr.set_range(req, 5, SQ, *kv)
    set_launches = count_diff(all_counts(), before)
    c = mgr.cache
    got = mgr.get_range(req, 5, SQ, SQ)
    set_ok = get_ok = True
    for i, (codes, scales) in enumerate(((c.k, c.k_scale), (c.v, c.v_scale))):
        q, s_ = quantize_rows_int8_reference(kv[i].reshape(-1, D))
        set_ok &= torch.equal(codes[5, slot, SQ:2 * SQ], q.reshape(SQ, H, D))
        set_ok &= torch.equal(scales[5, slot, SQ:2 * SQ], s_.reshape(SQ, H))
        get_ok &= torch.equal(got[i], q.reshape(SQ, H, D).float() * s_.reshape(SQ, H, 1))
    del codes, scales
    nbytes = mgr.device_bytes()
    want_bytes = sum(x.numel() * x.element_size() for x in c if x is not None)
    snap = [x.clone() for x in c if x is not None]
    del c, got
    t1 = time.perf_counter()
    mgr.offload_to_host()
    host_pinned = all(x.is_pinned() for x in mgr._host_cache if x is not None)
    mgr.restore_from_host()
    torch.cuda.synchronize()
    trip_s = time.perf_counter() - t1
    restored = all(torch.equal(a, b) for a, b in
                   zip(snap, [x for x in mgr.cache if x is not None]))
    del snap
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    mgr.clear()
    dropped = held - torch.cuda.memory_allocated(dev)
    print(f"pipeline kv manager (int8 cache): set_range launches {set_launches}, codes and "
          f"scales equal to the plain version {set_ok}, get_range equal to its plain "
          f"dequantization {get_ok}; device_bytes {nbytes} (the cache's {want_bytes}); "
          f"offload to pinned host ({host_pinned}) and back {trip_s:.3f} s, bit-equal "
          f"{restored}; clear() freed {dropped} bytes", flush=True)
    if not (set_ok and get_ok and restored and host_pinned and nbytes == want_bytes
            and dropped >= nbytes and set_launches == {"quantize_rows_int8": 2}):
        raise AssertionError("the KV manager disagrees with its plain versions or kept memory")
    del pipe, gen, mgr
    torch.cuda.empty_cache()

    never = [k for k in ("int8_matmul", "quantize_rows_int8", "adaln", "ln",
                         "flash_attention_prefix", "flash_attention_prefix_quant",
                         "halo_conv3d") if not path.get(k)]
    print(f"pipeline launches over its calls: {path}", flush=True)
    if never:
        raise AssertionError(f"the pipeline never launched {never}")
    phase("pipeline", t0)
    return path


# ---------------------------------------------------------------------------
# fp8 (e4m3) weight-only linears (TPU kernel 9), and the int8-PV attention
# entry points (TPU kernels 3 and 4)
# ---------------------------------------------------------------------------

# fp8 GEMM against its plain version, bf16 x on the card. Both sum exact
# products (bf16 times e4m3 is exact in f32) in f32, in other orders, then
# apply the same scale product and one rounding: an output may round to the
# neighbouring bf16 value, at most one bf16 ulp of the larger of the two.
# An output near 0 (a sum that cancels) differs by the f32 difference of the
# two sums itself, bounded by FP8_SUM_TOL times the sum of the products'
# magnitudes (|x| @ |dequantized w|; the orders' actual differences are
# ~2^-24 of it). Per element:
#     |out_kernel - out_plain| <= ulp_bf16(max(|kernel|, |plain|))
#                                 + FP8_SUM_TOL * (|x| @ |w_deq|)
# (measured from the plain product before the bias; with a bias, whose sum
# rounds once more, plus one ulp of the output). A wrong k tile, column or
# scale moves outputs by O(|out|). A moved rounding point (the product
# rounded to bf16 before the scale, as the JAX XLA chain does) stays within
# one ulp but flips ~20% of the outputs, where the summation orders flip
# 7e-5 to 7e-4 of them (H100 SXM): at most FP8_DIFF_SHARE may differ.
FP8_SUM_TOL = 2.0 ** -20
FP8_DIFF_SHARE = 1e-2
# One layer / one forward with the fp8 kernel against the same with the plain
# GEMM (the one-ulp differences above carried through bf16 layers): the bf16
# path's LAYER_RTOL and FORWARD_RTOL.


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (f32 tensor): 2^(e - 8) for |x| in
    [2^(e-1), 2^e); the smallest normal's spacing at 0."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def fp8_operands(dev, g, m, k, n, per_channel=True):
    """x bf16 N(0, 1); a weight U(-1/sqrt(K), 1/sqrt(K)) as init_params
    draws it, quantized on the card, its codes and scales checked bit for
    bit against the CPU quantizer's; the weight K-contiguous as the
    generator holds it; a bf16 bias. Returns (x, w_q, scale, bias)."""
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = ((torch.rand(k, n, generator=g, device=dev) * 2 - 1) / k ** 0.5).to(torch.bfloat16)
    w_q, scale = quantize_weight_fp8(w, per_channel)
    cq, cs = quantize_weight_fp8(w.cpu(), per_channel)
    if not (torch.equal(w_q.view(torch.uint8).cpu(), cq.view(torch.uint8))
            and torch.equal(scale.cpu(), cs)):
        raise AssertionError(f"e4m3 codes or scales of a [{k}x{n}] weight quantized "
                             "on the card differ from the CPU quantizer's")
    b = (torch.randn(n, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    return x, w_q.t().contiguous().t(), scale, b


def fp8_gemm_times(m, k, n, out_bytes=2):
    """(ops_ms, bytes_ms) of one fp8 GEMM: its operations at the bf16 peak;
    bf16 x, e4m3 w, f32 scales, bias and out read or written once."""
    nbytes = 2 * m * k + n * k + 4 * n + 2 * n + m * n * out_bytes
    return 2e3 * m * n * k / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S


def fp8_all_codes_exact(dev: torch.device) -> bool:
    """Every e4m3 code but the two NaNs widened exactly: the 254 codes (and
    two zeros) along K 256, w[n, k] = code k, x one-hot, scale 1, so
    out[m, n] = code m as bf16 (every e4m3 value is one), equal to the plain
    version's, tolerance 0. Catches a widening that flushes the subnormal
    codes or rounds any code."""
    codes = [c for c in range(256) if c not in (0x7F, 0xFF)] + [0, 0]
    row = torch.tensor(codes, dtype=torch.uint8).view(FP8)
    w = row.reshape(1, 256).expand(8, 256).contiguous().to(dev).t()
    x = torch.eye(256, dtype=torch.bfloat16, device=dev)
    ws = torch.ones(8, device=dev)
    out = fp8_matmul(x, w, ws)
    torch.cuda.synchronize()
    ref = fp8_matmul_reference(x, w, ws)
    ok = torch.equal(out, ref) and torch.equal(ref[:, 0].float().cpu(), row.float())
    err = (out.float() - ref.float()).abs().max().item()
    print(f"fp8w case fp8_matmul all_codes [256x256]x[256x8]: 254 finite codes, max_abs "
          f"{err:.3e} (tol 0) {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def fp8w_kernel_phase(dev: torch.device) -> dict:
    """B8 against its plain version at every main-path shape and a few
    edges, the wrapper refusing bad operands, then timed per layer beside
    its bound, the plain version and cuBLAS bf16 over a dequantized copy."""
    g = torch.Generator(device=dev).manual_seed(6)
    before = all_counts()
    cases = [(nm, m, k, n, {}) for nm, m, k, n, _ in LAYER_GEMMS] + [
        ("text_kv", TEXT, DIM, DIM, {}), ("m70_k8960", 70, FFN, DIM, {}),
        ("m1", 1, DIM, DIM, {}), ("per_tensor", SQ, DIM, DIM, dict(per_channel=False)),
        ("f32_out", SQ, DIM, DIM, dict(out_dtype=torch.float32)),
        ("no_bias_k16", 100, 16, 8, dict(bias=False))] + [
        (nm, m, k, n, {}) for nm, m, k, n in sched_gemms("fp8")]
    worst, failed = 0.0, []
    if not fp8_all_codes_exact(dev):
        failed.append("all_codes")
    for nm, m, k, n, kw in cases:
        check_gemm_plan(m, n, "fp8")
        x, w_q, ws, b = fp8_operands(dev, g, m, k, n, kw.get("per_channel", True))
        if not kw.get("bias", True):
            b = None
        od = kw.get("out_dtype", torch.bfloat16)
        out = fp8_matmul(x, w_q, ws, out_dtype=od, bias=b)
        torch.cuda.synchronize()
        ref = fp8_matmul_reference(x, w_q, ws, out_dtype=od, bias=b)
        o, r = out.float(), ref.float()
        diff = (o - r).abs()
        mag = torch.matmul(x.float().abs(), (w_q.float() * ws.reshape(1, -1)).abs())
        pre = fp8_matmul_reference(x, w_q, ws, out_dtype=od).float()  # before the bias
        if od == torch.bfloat16:
            bound = bf16_ulp(pre.abs()) + FP8_SUM_TOL * mag
            if b is not None:  # the bias sum rounds once more
                bound = bound + bf16_ulp(torch.maximum(o.abs(), r.abs()))
        else:
            bound = FP8_SUM_TOL * mag + 2.0 ** -23 * (pre.abs() + r.abs())
        share = (diff / bound).max().item()
        err = diff.max().item()
        differ = (diff > 0).float().mean().item()
        ok = (share <= 1 and (od == torch.float32 or differ <= FP8_DIFF_SHARE)
              and out.dtype == od and torch.isfinite(out).all().item())
        print(f"fp8w case fp8_matmul {nm} [{m}x{k}]x[{k}x{n}] -> {od}: max_abs {err:.3e}, "
              f"share of outputs that differ {differ:.3e} (tol {FP8_DIFF_SHARE:g} in bf16), "
              f"max |diff|/(ulp + {FP8_SUM_TOL:g} |x||w|) {share:.3f} (tol 1) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        worst = max(worst, err)
        if not ok:
            failed.append(nm)
    # the wrapper refuses what its kernel cannot take
    x, w_q, ws, b = fp8_operands(dev, g, 64, DIM, DIM)
    expect_raise("fp8_matmul float32 x", TypeError,
                 lambda: fp8_matmul(x.float(), w_q, ws, bias=b))
    expect_raise("fp8_matmul N-contiguous weight", ValueError,
                 lambda: fp8_matmul(x, w_q.contiguous(), ws, bias=b))
    expect_raise("fp8_matmul int8 weight", TypeError,
                 lambda: fp8_matmul(x, w_q.view(torch.int8), ws, bias=b))
    expect_raise("fp8_matmul scale length", ValueError,
                 lambda: fp8_matmul(x, w_q, ws[:7], bias=b))
    expect_raise("fp8_matmul K mismatch", ValueError,
                 lambda: fp8_matmul(x[:, :DIM - 16], w_q, ws, bias=b))
    if failed:
        raise AssertionError(f"fp8 GEMM cases {failed} disagree with the plain version")

    sums = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for nm, m, k, n, calls in LAYER_GEMMS + (("text_kv", TEXT, DIM, DIM, 0),):
        x, w_q, ws, b = fp8_operands(dev, g, m, k, n)
        ms = time_ms(lambda: fp8_matmul(x, w_q, ws, bias=b))
        plain = time_ms(lambda: fp8_matmul_reference(x, w_q, ws, bias=b))
        wd = (w_q.float() * ws).to(torch.bfloat16)      # [K, N], a dequantized copy
        lib = time_ms(lambda: torch.matmul(x, wd))
        ops_ms, bytes_ms = fp8_gemm_times(m, k, n)
        bound, by = bound_of(ops_ms, bytes_ms)
        print(f"fp8w time fp8_matmul {nm} [{m}x{k}]x[{k}x{n}]: {ms:.4f} ms "
              f"({gemm_rate('fp8', m, k, n, ms, bound)}), bound {bound:.4f} ms ({by}), "
              f"plain {plain:.4f} ms, cuBLAS bf16 matmul {lib:.4f} ms; {calls} a layer",
              flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            sums[key] += calls * v
    for key, (f, a) in KERNEL_COUNTERS.items():  # timing launches are not the path's
        setattr(f, a, before[key])
    bound_ms, bound_by = bound_of(sums["ops_ms"], sums["bytes_ms"])
    print(f"fp8w per layer: fp8_matmul {sums['ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; bytes {sums['bytes_ms']:.4f}), plain {sums['plain_ms']:.4f} ms, "
          f"cuBLAS bf16 {sums['library_ms']:.4f} ms", flush=True)
    return {"name": "fp8_matmul", "route": "cuda",
            "source": "inferix_tpu_torch/csrc/gemm_sm90.cu",
            "replaces": "inferix_tpu/quant/kernels.py:171", "launches": None,
            "max_abs_err": worst, "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sums["library_ms"],
            "work": "one fp8 layer at M=4680 (sum over its 6 GEMMs); library: "
                    "torch.matmul over a dequantized bf16 weight"}


def fp8w_config(blocks: int) -> EngineConfig:
    """Wan2.1-T2V-1.3B with fp8 weight-only linears (`--quant fp8`,
    inferix_tpu/cli.py:33: e4m3 per-channel block linears, bf16 KV, rerun)."""
    cfg = main_path_config(blocks)
    q = cfg.quant
    q.enabled, q.dtype, q.granularity = True, "fp8", "per_channel"
    q.quantize_kv_cache = False
    return cfg


def fp8w_main_phase(dev: torch.device, blocks: int) -> dict:
    """Generate `blocks` blocks with fp8 weights; launches at text encode and
    per block (B8 and flash only), output and cache checked, one layer and
    one forward against the plain GEMM, the flow against bf16's."""
    t0 = time.perf_counter()
    cfg = fp8w_config(blocks)
    m, r = cfg.model, cfg.runtime
    fpb = m.num_frame_per_block
    reset_counts()
    gen, xattn, noise, g = main_path_setup(dev, cfg)
    torch.cuda.synchronize()
    text = count_diff(all_counts(), {k: 0 for k in KERNEL_COUNTERS})
    qkv = gen.params["blocks"]["self_attn"]["qkv"]
    print(f"fp8w setup (weights quantized to e4m3, {memory_bytes(gen.params['blocks']) / 2**30:.3f} "
          f"GiB of block weights, qkv w_q {qkv['w_q'].dtype} strides {qkv['w_q'][0].stride()}, "
          f"text K/V): {time.perf_counter() - t0:.3f} s, launches at text encode {text}",
          flush=True)
    if text != {"fp8_matmul": 2 * m.num_layers} or qkv["w_q"].dtype != FP8:
        raise AssertionError(f"fp8w text-encode launches {text}, want "
                             f"{{'fp8_matmul': {2 * m.num_layers}}} and nothing else")
    n = m.num_layers * (len(gen.denoising_steps) + 1)
    want_block = {"fp8_matmul": 6 * n, "flash_attention_prefix": n}
    per_block, marks, prev = [], [time.perf_counter()], [all_counts()]

    def on_block(x0, bi):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_block.append(count_diff(all_counts(), prev[0]))
        prev[0] = all_counts()
        print(f"fp8w block {bi}: {marks[-1] - marks[-2]:.3f} s, launches {per_block[-1]}",
              flush=True)

    latents, cache = gen.generate(noise, xattn, generator=g, block_callback=on_block)
    torch.cuda.synchronize()
    total = all_counts()
    if per_block != [want_block] * blocks:
        raise AssertionError(f"fp8w launches per block {per_block}, want {want_block} "
                             "(no int8 GEMM, act-quant or LN prologue)")
    shape = (1, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    if tuple(latents.shape) != shape or not torch.isfinite(latents).all():
        raise AssertionError(f"fp8w latents {tuple(latents.shape)} (want {shape}) "
                             "or not finite")
    end = r.num_frames * gen.frame_seq
    for buf in (cache.k, cache.v):
        if not (buf[:, :, :end].abs().amax(dim=(-1, -2)) > 0).all():
            raise AssertionError("a written fp8w cache slot is zero")
        if buf[:, :, end:].any():
            raise AssertionError("an fp8w cache slot past the span was written")
    secs = [marks[i + 1] - marks[i] for i in range(len(per_block))]
    print(f"fp8w main path: latents {tuple(latents.shape)} finite, |x0| max "
          f"{latents.float().abs().max().item():.3f}, s/block "
          f"{', '.join(f'{x:.3f}' for x in secs)}, cache slots [0, {end}) written in all "
          f"{m.num_layers} layers, rest zero", flush=True)

    # one layer, then one whole forward, B8 vs the plain GEMM
    f0 = r.num_frames - fpb
    start = f0 * gen.frame_seq
    geo, spec = gen.statics.geo, gen.statics.spec
    x_blk = latents[:, f0:]
    t = torch.full((1, fpb), gen.denoising_steps[0], device=dev)
    with torch.inference_mode():
        tokens = patch_embed(gen.params, m, x_blk)
        _, e0 = time_embeddings(gen.params, m, t)
        angles = rope_angles(gen.rope_tables, fpb, geo.grid_h, geo.grid_w, f0)
        mask = valid_mask(spec, start + geo.tokens, device=dev)
        blk = layer_params(gen.params["blocks"], 0)
        ys, flows = [], []
        for plain in (False, True):
            before = all_counts()
            with (mock.patch.object(quant_api, "fp8_matmul", fp8_matmul_reference)
                  if plain else contextlib.nullcontext()):
                lc = (cache.k[0].clone(), cache.v[0].clone())
                y, _ = block_forward(blk, m, spec, tokens, e0, angles, lc, xattn.k[0],
                                     xattn.v[0], start, mask)
                flow, _ = dit_forward_inference(gen.params, gen.statics, gen.rope_tables,
                                                x_blk, t, xattn, cache, start)
            moved = count_diff(all_counts(), before).get("fp8_matmul", 0)
            if moved != (0 if plain else 6 * (1 + m.num_layers)):
                raise AssertionError(f"fp8w: fp8_matmul launched {moved} times in the "
                                     f"{'plain' if plain else 'kernel'} run")
            ys.append(y)
            flows.append(flow)
        layer_err = rel_err(ys[0] - tokens, ys[1] - tokens)
        fwd_err = rel_err(flows[0], flows[1])
    print(f"fp8w block_forward fp8_matmul vs plain: update rel err {layer_err:.3e} "
          f"(tol {LAYER_RTOL:g}); dit_forward_inference flow rel err {fwd_err:.3e} "
          f"(tol {FORWARD_RTOL:g})", flush=True)
    if not (layer_err <= LAYER_RTOL and fwd_err <= FORWARD_RTOL):
        raise AssertionError("the fp8w path with its kernel disagrees with the plain GEMM")

    # for information: the fp8 flow against the bf16 flow, same weights
    del gen
    torch.cuda.empty_cache()
    bgen, bxattn, _, _ = main_path_setup(dev, main_path_config(blocks))
    with torch.inference_mode():
        bflow, _ = dit_forward_inference(bgen.params, bgen.statics, bgen.rope_tables,
                                         x_blk, t, bxattn, cache, start)
    print(f"fp8w vs bf16 (information, not a gate): flow rel err "
          f"{rel_err(flows[0], bflow):.3e}", flush=True)
    del bgen, bxattn, cache
    torch.cuda.empty_cache()
    phase("fp8w main", t0)
    return total


# The int8-PV attention kernels against their plain versions, code by code:
# the kernel writes every p code it forms (an output the path never asks
# for) and each group's codes are compared with the plain version's
# round(u). Both kernels form s - m with one rounding where the plain
# version rounds s first (an FMA), take p from ex2.approx (exp2f's value for
# a normal p), and the i8 kernel takes the codes' scale from an estimate of
# the group's max(p * v_scale), exp2(max(s + lg2 v_scale) - m), within ~1e-6
# of the exact max (its dequantization step stays the exact one); the v2
# kernel also sums its bf16 QK products in f32 in another order than the
# plain version's exact sum, so its logits differ in their last bits (at
# worst ~1e-4 of the |q||k| sum over 128 products, typically ~1e-6). Each
# moves u by at most ~1e-2 of a code step at u ~ 127. A code may therefore
# differ only by 1 and only where the plain u lies within CODE_TIE of a
# rounding tie; at most CODE_FLIP_SHARE of the live codes may do so. The output is then
# bounded through the flips: per element
#     |out_kernel - out_plain| <= sum over flips of |v_q| deq 2^(m_g - m) / l
#                                 + 2^-7 max(|out_kernel|, |out_plain|)
#                                 + ACC_TOL sum over groups of |PV_g| 2^(m_g - m) / l
# (the second term: one bf16 ulp; the third: an output that cancels to ~0
# over the groups, where the f32 accumulator's roundings and corrections
# exp2(m - m_new) from maxima a few ulps apart dominate: ~1e-7 of the
# groups' magnitudes at |out| ~ 1e-9, H100 SXM), and the LSE within
# LSE_ATOL + 1e-6 |lse| (kv_len 0: -6.9e29).
CODE_TIE = 1e-2
CODE_FLIP_SHARE = 1e-4
ACC_TOL = 2.0 ** -16


def quant_attention_bound(mode: str, b: int, span: int):
    """(bound_ms, bound_by) of an int8-PV kernel over `span` live keys: QK
    and PV operations at their peaks (i8: both int8; v2: QK bf16, PV int8);
    bytes of q, the int8 K/V span, their scales and the bf16 output."""
    prod = 2.0 * b * H * SQ * span * D
    ops_s = prod / PEAK_INT8_OPS + (prod / PEAK_INT8_OPS if mode == "i8"
                                    else prod / PEAK_BF16_FLOPS)
    q_bytes = b * SQ * H * (D + 4 if mode == "i8" else 2 * D)
    nbytes = q_bytes + b * span * H * (2 * D + 8) + 2.0 * b * SQ * H * D
    return bound_of(ops_s * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3)


def quant_span_times(mode, kern, q, kq, vq, ks, vs):
    """An int8-PV kernel at the spans of a clip's blocks 0, 2 and 6 (the
    full cache's tensors, kv_len = span) beside its bound and SDPA over a
    dequantized bf16 copy of the same span."""
    for span in SPANS:
        t = time_ms(lambda: kern(q, kq, vq, ks, vs, span))
        kd, vd = dequantize(kq[:, :span], ks[:, :span]), dequantize(vq[:, :span], vs[:, :span])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        del kd, vd, qt, kt, vt
        bnd, by = quant_attention_bound(mode, q.shape[0], span)
        print(f"qattn time {kern.__name__} span {span}: {t:.4f} ms, sdpa {lib:.4f} ms, "
              f"bound {bnd:.4f} ms ({by})", flush=True)


def check_quant_ext_case(mode, label, q, kq, vq, ks, vs, kv_len, kv_block, lse_on):
    """Run the kernel with its code output and the plain version group by
    group; returns (ok, max |out diff|, flips)."""
    b = q.shape[0]
    skv = kq.shape[1]
    codes = torch.zeros(b, H, SQ, skv, dtype=torch.uint8, device=q.device)
    res = quant_ext_kernel(mode, q, kq, vq, ks, vs, kv_len, kv_block=kv_block,
                           return_lse=True, codes=codes)
    out, lse = res
    if not lse_on:  # the kernel without an lse output writes the same out
        if not torch.equal(quant_ext_kernel(mode, q, kq, vq, ks, vs, kv_len,
                                            kv_block=kv_block), out):
            raise AssertionError(f"{label}: the kernel's out depends on return_lse")
    torch.cuda.synchronize()
    stats = dict(live=0, flips=0, far=0, big=0, worst_tie=0.0)
    carried = {}  # batch row -> (flip mass, accumulator mass, running max)

    def on_group(i, g0, g1, u, m, deq):
        want = torch.round(u)
        d = codes[i, :, :, g0:g1].float() - want
        stats["live"] += u.numel()
        flips = d != 0
        v_abs = vq[i, g0:g1].permute(1, 0, 2).float().abs()
        acc_mass = torch.matmul(want, v_abs) * deq
        flip_mass = torch.zeros_like(acc_mass)
        nf = int(flips.sum())
        if nf:
            stats["flips"] += nf
            stats["big"] += int((d.abs() > 1).sum())
            tie = (u - torch.floor(u) - 0.5).abs()
            stats["worst_tie"] = max(stats["worst_tie"], tie[flips].max().item())
            stats["far"] += int((tie[flips] > CODE_TIE).sum())
            flip_mass = torch.matmul(d.abs(), v_abs) * deq
        if i in carried:  # carried as the accumulator is: rescaled to the new max
            f0, a0, m0 = carried[i]
            c = torch.exp2(m0 - m)
            flip_mass, acc_mass = f0 * c + flip_mass, a0 * c + acc_mass
        carried[i] = (flip_mass, acc_mass, m)

    ref, ref_lse = quant_ext_reference(mode, q, kq, vq, ks, vs, kv_len, None,
                                        kv_block, True, on_group=on_group)
    o, r = out.float(), ref.float()
    bound = 2.0 ** -7 * torch.maximum(o.abs(), r.abs())
    for i, (flip_mass, acc_mass, m_fin) in carried.items():
        denom = torch.exp2(ref_lse[i][..., None] * LOG2E - m_fin)
        bound[i] += ((flip_mass + ACC_TOL * acc_mass) / denom).permute(1, 0, 2)
    diff = (o - r).abs()
    share = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0)).max().item()
    lse_err = ((lse - ref_lse).abs() - 1e-6 * ref_lse.abs()).max().item()
    flip_share = stats["flips"] / max(stats["live"], 1)
    ok = (stats["big"] == 0 and stats["far"] == 0 and flip_share <= CODE_FLIP_SHARE
          and share <= 1 and lse_err <= LSE_ATOL and torch.isfinite(out).all().item())
    print(f"{label}: {stats['live']} live codes, {stats['flips']} differ (share "
          f"{flip_share:.2e}, tol {CODE_FLIP_SHARE:g}; by more than 1: {stats['big']}; "
          f"further than {CODE_TIE:g} from a tie: {stats['far']}, worst "
          f"{stats['worst_tie']:.2e}); out max_abs {diff.max().item():.3e}, max |diff| / "
          f"bound {share:.3f} (tol 1); lse max_abs - 1e-6|lse| {lse_err:.3e} "
          f"(tol {LSE_ATOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    del codes
    return ok, diff.max().item(), stats["flips"]


def quant_attention_kernel_phase(dev: torch.device) -> list:
    """B9 and B10 against their plain versions at the full-cache shape and
    the edges, the wrappers refusing bad operands, then timed beside the
    bound, the plain version and SDPA over a dequantized bf16 copy."""
    g = torch.Generator(device=dev).manual_seed(7)
    before = all_counts()
    q2 = torch.randn(2, SQ, H, D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(torch.randn(2, SKV, H, D, generator=g, device=dev)
                               .to(torch.bfloat16))
    vq, vs = quantize_kv_block(torch.randn(2, SKV, H, D, generator=g, device=dev)
                               .to(torch.bfloat16))
    rows = torch.tensor([SKV, 18720], device=dev)
    cases = [  # (name, batch rows, kv_len, kv_block, lse)
        ("full_b1", 1, SKV, None, True), ("full_b1_no_lse", 1, SKV, None, False),
        ("b2_rows", 2, rows, None, True), ("len30000", 1, 30000, None, True),
        ("len1", 1, 1, None, True), ("len0", 1, 0, None, True),
        ("kv_block128", 1, SKV, 128, True),
        # groups that end inside a 128-key tile: 192 = 1.5 tiles, 64 = half of one
        ("kv_block192", 1, SKV, 192, True), ("len4680_kv_block64", 1, SQ, 64, True)]
    entries, failed = [], []
    for mode, kern, body in (("i8", flash_attention_prefix_quant_i8, 660),
                             ("v2", flash_attention_prefix_quant_v2, 962)):
        worst = 0.0
        for case, b, kv_len, kvb, lse_on in cases:
            ok, err, _ = check_quant_ext_case(
                mode, f"qattn case {kern.__name__} {case}", q2[:b], kq[:b], vq[:b],
                ks[:b], vs[:b], kv_len, kvb, lse_on)
            worst = max(worst, err)
            if not ok:
                failed.append(f"{mode} {case}")
            torch.cuda.empty_cache()
        args = (q2[:1], kq[:1], vq[:1], ks[:1], vs[:1], SKV)
        ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: quant_ext_reference(mode, *args, None, None, False),
                           iters=3, warmup=1)
        kd, vd = dequantize(kq[:1], ks[:1]), dequantize(vq[:1], vs[:1])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q2[:1], kd, vd))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
        print(f"qattn {kern.__name__} full cache vs SDPA over the dequantized bf16 cache "
              f"(information): rel err {rel_err(kern(*args), sdpa):.3e}", flush=True)
        del kd, vd, qt, kt, vt, sdpa
        quant_span_times(mode, kern, *args[:5])
        bound_ms, bound_by = quant_attention_bound(mode, 1, SKV)
        print(f"qattn time {kern.__name__} full cache: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa over a dequantized bf16 copy {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        entries.append({
            "name": kern.__name__, "route": "cuda",
            "source": "inferix_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": f"inferix_tpu/ops/flash_attention.py:{body}", "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "work": "B=1, 4680 q over 32760 int8 keys, kv group 2048; entry point only "
                    "(no engine path calls it)"})
    # the operand pre-pass against its plain versions, exact (a ragged cache
    # view too: 100 of the cache's tokens, n32 = 128)
    for label, kk, vv in (("[2, 32760]", kq, vq), ("[2, 100] view", kq[:, :100], vq[:, :100])):
        vt, kb = quant_operands(kk, vv, True)
        ok = torch.equal(vt, pv_operand(vv)) and torch.equal(kb, kk.to(torch.bfloat16))
        print(f"qattn operand pre-pass {label}: V^T and bf16 K equal to the plain versions "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"operand pre-pass {label}")
        del vt, kb
    # the wrappers refuse what their kernels cannot take
    kb16 = kq[:1].to(torch.bfloat16)
    expect_raise("flash_attention_prefix_quant_i8 bf16 K/V", TypeError,
                 lambda: flash_attention_prefix_quant_i8(q2[:1], kb16, kb16, ks[:1], vs[:1], SKV))
    expect_raise("flash_attention_prefix_quant_v2 float32 q", TypeError,
                 lambda: flash_attention_prefix_quant_v2(q2[:1].float(), kq[:1], vq[:1],
                                                         ks[:1], vs[:1], SKV))
    expect_raise("flash_attention_prefix_quant_v2 kv_block 96", ValueError,
                 lambda: flash_attention_prefix_quant_v2(q2[:1], kq[:1], vq[:1], ks[:1],
                                                         vs[:1], SKV, kv_block=96))
    expect_raise("flash_attention_prefix_quant_i8 bf16 scales", ValueError,
                 lambda: flash_attention_prefix_quant_i8(q2[:1], kq[:1], vq[:1],
                                                         ks[:1].bfloat16(), vs[:1], SKV))
    # the tensor maps' rule (`check_tma_kv`): K/V strides that are positive
    # multiples of 16 bytes, at least one token
    for kern in (flash_attention_prefix_quant_i8, flash_attention_prefix_quant_v2):
        name = kern.__name__
        kpad = torch.zeros(1, 64, H * D + 8, dtype=torch.int8, device=dev)
        k_odd = kpad[..., :H * D].view(1, 64, H, D)       # token stride 1544 bytes
        expect_raise(f"{name} token stride 1544 bytes", ValueError,
                     lambda: kern(q2[:1], k_odd, k_odd, ks[:1, :64], vs[:1, :64], 64))
        k_bcast = kq[:1, :1].expand(1, 64, H, D)          # token stride 0
        expect_raise(f"{name} token stride 0", ValueError,
                     lambda: kern(q2[:1], k_bcast, vq[:1, :64], ks[:1, :64], vs[:1, :64], 64))
        expect_raise(f"{name} V token stride 0", ValueError,
                     lambda: kern(q2[:1], kq[:1, :64], k_bcast, ks[:1, :64], vs[:1, :64], 64))
        expect_raise(f"{name} empty cache", ValueError,
                     lambda: kern(q2[:1], kq[:1, :0], vq[:1, :0], ks[:1, :0], vs[:1, :0], 0))
        del kpad, k_odd, k_bcast
    for key, (f, a) in KERNEL_COUNTERS.items():  # these launches are not a path's
        setattr(f, a, before[key])
    if failed:
        raise AssertionError(f"int8-PV attention cases {failed} disagree with the plain versions")
    return entries




# ---------------------------------------------------------------------------
# The text and image encoders (A10) and the other Wan pipelines (A11: CFG,
# CausVid, continuous batching), and the I2V-14B DiT: phases 16-21
# ---------------------------------------------------------------------------

# bf16 against the float32 run of the same function on the same weights, in
# norm over the real positions: each bf16 layer rounds its products and
# elementwise results (2^-9 relative a rounding); a misplaced rounding point
# or a wrong op moves a layer's output by O(1) of its norm. CLIP and XLM-R
# (scaled attention, logits of O(1)) are held end to end. UMT5's attention
# is unscaled: under the JAX initialiser's N(0, 1/in) weights its logits
# have a standard deviation of ~8 (64 products of unit q and k), its
# softmax sits near one-hot and bf16's rounding of q and k moves which key
# wins here and there; over 24 layers the two runs drift apart (0.66 of the
# features' norm at UMT5-XXL on an NVIDIA H100 80GB HBM3 at 700 W). So UMT5 is held layer by layer:
# each layer's update in bf16 against the same layer in float32 on the same
# bf16 input, the bf16 output feeding the next layer; the end-to-end
# difference is printed beside it.
ENCODER_RTOL = 5e-2
# A stream generated beside others against the same stream alone at B=1 (the
# same per-slot draws): the W8A8 path's int8 sums are exact and every kernel
# works row by row, so the rows can differ only where a library call (the
# cuBLAS bf16 GEMMs of the patch embedding, the head and the batched
# cross-attention products) picks another algorithm for another M; such a
# one-ulp difference is carried through the blocks like FORWARD_RTOL's.
STREAM_RTOL = 5e-2
UMT5_PROMPTS = ("a red fox runs across a snowy field at dawn, its breath steaming "
                "in the cold air", "a small boat")
CFG_STEPS, CFG_BLOCKS, DPM_STEPS = 20, 2, 8
I2V_14B = dict(model_type="i2v", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
               in_dim=36, out_dim=16)  # Wan-AI/Wan2.1-I2V-14B-480P config.json
I2V_BLOCKS, I2V_COND = 2, 20           # 4 mask + 16 image-latent channels


class ByteTokenizer:
    """A deterministic stand-in for the UMT5 tokenizer (the HF call
    signature): a prompt's UTF-8 bytes b -> ids 3 + b, then EOS 1, padded
    with 0 to max_length, with the attention mask."""

    def __call__(self, prompts, padding="max_length", truncation=True, max_length=512,
                 return_tensors="np", **kw):
        import numpy as np
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            toks = ([3 + b for b in p.encode()] + [1])[:max_length]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}


def cast_tree(tree, dtype):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def timed(fn):
    """(fn(), seconds), the device synchronized before and after."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t1


def umt5_layer_errors(params, cfg: UMT5Config, ids: torch.Tensor,
                      mask: torch.Tensor) -> list:
    """Each UMT5 layer in bf16 against the same layer in float32 on the same
    bf16 input: the rel err of its update over the real positions; the bf16
    output feeds the next layer (umt5_encode's loop, teacher-forced)."""
    dev = ids.device
    buckets = torch.as_tensor(umt5_mod.relative_position_buckets(
        ids.shape[1], cfg.num_buckets, cfg.max_dist), dtype=torch.long, device=dev)
    mask_bias = torch.where(mask[:, None, None, :] > 0, torch.zeros((), device=dev),
                            torch.full((), -1e9, device=dev))
    real = mask[..., None].bool()
    x = params["token_embedding"][ids]
    errs = []
    for i in range(cfg.num_layers):
        blk = layer_params(params["blocks"], i)
        ys = [umt5_mod._t5_layer_body(xx, blk, mask_bias, None, buckets, cfg.num_heads,
                                      cfg.head_dim) for xx in (x, x.float())]
        errs.append(rel_err(torch.where(real, ys[0].float() - x.float(), 0),
                            torch.where(real, ys[1] - x.float(), 0)))
        x = ys[0]
    return errs


def text_encoder_phase(dev: torch.device, smi: str):
    """Phase 16: WanTextEncoder at UMT5-XXL width and depth (bf16, B=2
    prompts of other lengths, text_len 512): padded rows exactly 0, the
    features against the float32 run on the same weights, stream_layers=True
    bit-equal to the resident run with both peaks; CLIP ViT-H/14 and XLM-R
    large (CLIP text head) against their float32 runs. Returns (the resident
    encoder, the CLIP features [1, 257, 1280] float32)."""
    t0 = time.perf_counter()
    cfg = UMT5Config()
    g = torch.Generator(device=dev).manual_seed(16)
    params, draw_s = timed(lambda: init_umt5_params(cfg, g, device=dev))
    tower = memory_bytes(params)
    print(f"text: UMT5-XXL drawn on the card ({tower / 2**30:.3f} GiB bf16): {draw_s:.3f} s",
          flush=True)
    tok = ByteTokenizer()
    enc = WanTextEncoder(cfg, params=params, tokenizer=tok, device=dev)
    lengths = [len(p.encode()) + 1 for p in UMT5_PROMPTS]
    enc(UMT5_PROMPTS)  # warm-up: cuBLAS handles and kernels
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    feats, resident_s = timed(lambda: enc(UMT5_PROMPTS))
    resident_peak = torch.cuda.max_memory_allocated(dev)
    pad_zero = all(not feats[i, n:].any() for i, n in enumerate(lengths))
    real_nonzero = all(bool(feats[i, :n].abs().amax(-1).gt(0).all())
                       for i, n in enumerate(lengths))
    ids = torch.as_tensor(tok(list(UMT5_PROMPTS))["input_ids"], device=dev)
    mask = (ids > 0).to(torch.int32)
    with torch.inference_mode():
        f32, f32_s = timed(lambda: umt5_encode(
            {**params, "token_embedding": params["token_embedding"].float()}, cfg, ids, mask))
        layer_errs = umt5_layer_errors(params, cfg, ids, mask)
    m = mask[..., None].bool()
    err = rel_err(torch.where(m, feats.float(), 0), torch.where(m, f32, 0))
    print(f"text: WanTextEncoder UMT5-XXL bf16, 2 prompts of {lengths} tokens over 512: "
          f"{resident_s:.3f} s, peak device bytes {resident_peak} (tower {tower}, before "
          f"the call {base}); padded rows exactly 0 {pad_zero}, real rows nonzero "
          f"{real_nonzero}; each layer's update against float32 on its bf16 input: rel "
          f"err max {max(layer_errs):.3e}, median {statistics.median(layer_errs):.3e} (tol "
          f"{ENCODER_RTOL:g}); end to end against the float32 run ({f32_s:.3f} s) rel err "
          f"{err:.3e} (the unscaled attention's drift, not a gate); {smi}", flush=True)
    if not (pad_zero and real_nonzero and max(layer_errs) <= ENCODER_RTOL
            and tuple(feats.shape) == (2, 512, cfg.dim)):
        raise AssertionError("the UMT5 layers disagree with their float32 runs, or the "
                             "padding is not zero")
    del f32

    # the tower on pinned host memory, streamed a layer at a time; the
    # device copy dropped while the streamed encoder runs
    streamed_enc, pin_s = timed(lambda: WanTextEncoder(cfg, params=params, tokenizer=tok,
                                                       device=dev, stream_layers=True))
    host = {k: streamed_enc.params[k] for k in ("blocks", "token_embedding")}
    enc.params = None
    del params
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    streamed, stream_s = timed(lambda: streamed_enc(UMT5_PROMPTS))
    stream_peak = torch.cuda.max_memory_allocated(dev)
    equal = torch.equal(streamed, feats)
    print(f"text: stream_layers=True (blocks and embedding pinned on the host in "
          f"{pin_s:.3f} s): {stream_s:.3f} s, peak device bytes {stream_peak} (before the "
          f"call {base}) against the resident run's {resident_peak}; bit-equal to the "
          f"resident run {equal}; {smi}", flush=True)
    if not equal or stream_peak >= resident_peak:
        raise AssertionError("the streamed UMT5 run differs from the resident one or "
                             "did not lower the peak")
    # the resident encoder again, for phases 17-18
    enc.params = {**streamed_enc.params, **tree_map(lambda a: a.to(dev), host)}
    del streamed_enc, streamed, host

    # CLIP ViT-H/14 on a 224^2 image, bf16 against float32 (the same
    # bf16-rounded weights)
    ccfg = CLIPVisionConfig()
    gc = torch.Generator(device=dev).manual_seed(161)
    cparams = cast_tree(init_clip_vision_params(ccfg, gc, device=dev), torch.bfloat16)
    image = torch.rand(1, ccfg.image_size, ccfg.image_size, 3, generator=gc, device=dev) * 2 - 1
    with torch.inference_mode():
        clip_vision_encode(cparams, ccfg, image.to(torch.bfloat16))  # warm-up
        clip_bf16, clip_s = timed(lambda: clip_vision_encode(cparams, ccfg,
                                                             image.to(torch.bfloat16)))
        clip_f32, clip32_s = timed(lambda: clip_vision_encode(
            cast_tree(cparams, torch.float32), ccfg, image))
    clip_err = rel_err(clip_bf16, clip_f32)
    print(f"text: clip_vision_encode ViT-H/14 (32 layers, width 1280) -> "
          f"{tuple(clip_bf16.shape)}: bf16 {clip_s:.3f} s, float32 {clip32_s:.3f} s, rel err "
          f"{clip_err:.3e} (tol {ENCODER_RTOL:g}); {smi}", flush=True)
    if tuple(clip_bf16.shape) != (1, ccfg.num_tokens, ccfg.width) or not clip_err <= ENCODER_RTOL:
        raise AssertionError("the CLIP tower disagrees with its float32 run")
    del cparams, clip_bf16

    # XLM-R large with the CLIP head (out 1024), 77 tokens of two prompts
    xcfg = XLMRobertaConfig(out_dim=1024)
    gx = torch.Generator(device=dev).manual_seed(162)
    xparams = cast_tree(init_xlm_roberta_params(xcfg, gx, device=dev), torch.bfloat16)
    xids = torch.full((2, 77), xcfg.pad_id, dtype=torch.long, device=dev)
    for i, p in enumerate(UMT5_PROMPTS):
        toks = [0] + [3 + b for b in p.encode()][:75] + [2]
        xids[i, :len(toks)] = torch.tensor(toks, device=dev)
    with torch.inference_mode():
        xlm_roberta_clip_text(xparams, xcfg, xids)  # warm-up
        x_bf16, xlm_s = timed(lambda: xlm_roberta_clip_text(xparams, xcfg, xids))
        x_f32, xlm32_s = timed(lambda: xlm_roberta_clip_text(
            cast_tree(xparams, torch.float32), xcfg, xids))
    xlm_err = rel_err(x_bf16, x_f32)
    print(f"text: xlm_roberta_clip_text large (24 layers, dim 1024) -> "
          f"{tuple(x_bf16.shape)}: bf16 {xlm_s:.3f} s, float32 {xlm32_s:.3f} s, rel err "
          f"{xlm_err:.3e} (tol {ENCODER_RTOL:g}); {smi}", flush=True)
    if tuple(x_bf16.shape) != (2, xcfg.out_dim) or not xlm_err <= ENCODER_RTOL:
        raise AssertionError("XLM-R disagrees with its float32 run")
    del xparams
    torch.cuda.empty_cache()
    phase("text encoders", t0)
    return enc, clip_f32


def umt5_pipeline_phase(dev: torch.device, smi: str, enc) -> dict:
    """Phase 17: phase 15's run_text_to_video (W8A8, 21 frames, AFTER_ALL)
    with the UMT5-XXL WanTextEncoder: launches a block, the latents
    bit-equal to SemiARGenerator.generate on the same features and draws,
    the time to the first block (text encode included)."""
    t0 = time.perf_counter()
    cfg = pipeline_config()
    m, r = cfg.model, cfg.runtime
    pipe = SelfForcingPipeline(cfg, text_encoder=enc, device=dev)
    pipe.setup()
    gen = pipe.generator
    want_block = w8a8_block_launches(gen, False)
    want_text = {"int8_matmul": 2 * m.num_layers, "quantize_rows_int8": 2 * m.num_layers}
    reset_counts()
    marks, per_block = [all_counts()], []

    def on_block(x0, bi):
        marks.append(all_counts())
        per_block.append(count_diff(marks[-1], marks[-2]))

    (video, latents), t2v_s = timed(lambda: pipe.run_text_to_video(
        ["a red fox"], return_latents=True, decode_mode=DecodeMode.AFTER_ALL,
        block_callback=on_block))
    path = all_counts()
    blocks = r.num_frames // m.num_frame_per_block
    want = [{k: v + want_text.get(k, 0) for k, v in want_block.items()}] \
        + [want_block] * (blocks - 1)
    shape = (1, r.num_frames, r.latent_height, r.latent_width, r.latent_channels)
    with torch.inference_mode():
        noise, g, renoise = pipe._draw_noise(r.seed, shape)
        ref, _ = gen.generate(noise, pipe._encode_prompts(["a red fox"]), generator=g,
                              renoise=renoise)
    equal = torch.equal(ref, latents)
    prof = pipe.profiler.summary()
    print(f"pipeline with UMT5-XXL: t2v AFTER_ALL {t2v_s:.3f} s, time to the first block "
          f"{prof['time_to_first_block_s']:.3f} s (text encode included), profiler s/block "
          f"{', '.join(f'{b['time_ms'] / 1e3:.3f}' for b in pipe.profiler.blocks)}; latents "
          f"bit-equal to SemiARGenerator.generate {equal}; launches block 0 {per_block[0]}, "
          f"then {per_block[1]}; video {tuple(video.shape)}; {smi}", flush=True)
    if not equal or per_block != want or not torch.isfinite(video).all():
        raise AssertionError(f"the UMT5-fed pipeline: bit-equal {equal}, launches "
                             f"{per_block} (want {want})")
    del pipe, gen, video, latents, ref
    torch.cuda.empty_cache()
    phase("umt5 pipeline", t0)
    return path


def cfg_phase(dev: torch.device, smi: str, enc) -> dict:
    """Phase 18: CausalDiffusionPipeline on Wan2.1-T2V-1.3B in bf16, B=1 (a
    2-row cache), positive and negative prompts through UMT5-XXL: UniPC with
    CFG_STEPS steps over CFG_BLOCKS blocks, then DPM++ with DPM_STEPS over 1
    block at guidance 5 and 0. Launches (steps + 1) x 30 B1 a block; one
    forward at B=2 with the kernel against plain attention."""
    t0 = time.perf_counter()
    cfg = main_path_config(CFG_BLOCKS)
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(18)
    params = init_params(m, g, device=dev)
    path, last = {}, {}

    def run(solver, steps, frames, guidance):
        pipe = CausalDiffusionPipeline(cfg, params=params, num_sampling_steps=steps,
                                       sample_solver=solver, text_encoder=enc, device=dev)
        real, per_block, secs = pipe._cfg_block, [], []

        def block(cache, xattn, noisy, start, gs):
            before = all_counts()
            out, s = timed(lambda: real(cache, xattn, noisy, start, gs))
            per_block.append(count_diff(all_counts(), before))
            secs.append(s)
            last.update(pipe=pipe, cache=cache, xattn=xattn, start=start, latents=out)
            return out

        pipe._cfg_block = block
        before = all_counts()
        out = pipe.run_text_to_video(["a red fox"], negative_prompts=["blurry, static"],
                                     num_frames=frames, guidance_scale=guidance)
        add_counts(path, count_diff(all_counts(), before))
        want = [{"flash_attention_prefix": (steps + 1) * m.num_layers}] * (frames // 3)
        print(f"cfg {solver} {steps} steps, guidance {guidance}: s/block "
              f"{', '.join(f'{x:.3f}' for x in secs)}, launches a block {per_block} (want "
              f"{want[0]}), latents {tuple(out.shape)}; {smi}", flush=True)
        if per_block != want or not torch.isfinite(out).all():
            raise AssertionError(f"cfg {solver}: launches {per_block}, want {want}")
        return out

    run("unipc", CFG_STEPS, 3 * CFG_BLOCKS, None)
    # one forward at B=2 (the cond / uncond pair) of the last block, kernel
    # against plain attention, over the cache as generated
    pipe, cache = last["pipe"], last["cache"]
    pair = torch.cat([last["latents"]] * 2)
    t = torch.full((2, 3), float(pipe.solver.timesteps[0]), device=dev)
    flows = []
    with torch.inference_mode():
        for plain in (False, True):
            with mock.patch.object(attention_mod, "flash_attention",
                                   plain_flash_attention if plain
                                   else attention_mod.flash_attention):
                flow, _ = dit_forward_inference(pipe._params, pipe.statics, pipe.rope_tables,
                                                pair, t, last["xattn"], cache, last["start"])
            flows.append(flow)
    fwd_err = rel_err(flows[0], flows[1])
    print(f"cfg dit_forward_inference at B=2 kernel vs plain: flow rel err {fwd_err:.3e} "
          f"(tol {FORWARD_RTOL:g})", flush=True)
    if not fwd_err <= FORWARD_RTOL:
        raise AssertionError("the CFG pair's forward with the kernel disagrees with plain")
    del pipe, cache, flows, pair
    last.clear()
    g5 = run("dpm++", DPM_STEPS, 3, 5.0)
    g0 = run("dpm++", DPM_STEPS, 3, 0.0)
    moved = rel_err(g5, g0)
    print(f"cfg dpm++: guidance 5 against guidance 0, rel diff {moved:.3e} (must be > 0)",
          flush=True)
    if not moved > 0:
        raise AssertionError("guidance did not change the CFG latents")
    last.clear()
    torch.cuda.empty_cache()
    phase("cfg", t0)
    return path


def causvid_phase(dev: torch.device, smi: str) -> dict:
    """Phase 19: CausVidPipeline.run_rollouts with fp8 weight-only linears
    (`--quant fp8`) and the int8 KV cache, 2 rollouts of 9 frames with two
    prompts, a 3-frame overlap, the bf16 halo VAE."""
    t0 = time.perf_counter()
    cfg = causvid_config()
    r, q = cfg.runtime, cfg.quant
    q.enabled, q.dtype, q.granularity = True, "fp8", "per_channel"
    q.quantize_kv_cache, q.kv_cache_dtype = True, "int8"
    r.frames_per_segment, r.vae_conv_impl = SEGMENT_FRAMES, "halo"
    pipe = CausVidPipeline(cfg, text_encoder=StandInTextEncoder(dev), device=dev)
    pipe.setup()
    gen, vae = pipe.generator, pipe.vae
    n = cfg.model.num_layers
    forwards = len(gen.denoising_steps) + 1
    want_block = {"fp8_matmul": 6 * n * forwards, "flash_attention_prefix_quant": n * forwards,
                  "quantize_rows_int8": 2 * n * forwards}
    want_ctx = {k: v // forwards for k, v in want_block.items()}
    blocks, ctx, starts, seg_latents = [], [], [], []

    def counted(real, into):
        def fn(*a, **k):
            before = all_counts()
            out = real(*a, **k)
            into.append(count_diff(all_counts(), before))
            return out
        return fn

    gen.denoise_block = counted(gen.denoise_block, blocks)
    gen.cache_context_block = counted(gen.cache_context_block, ctx)
    real_start, real_t2v = pipe._encode_start_latents, pipe.run_text_to_video
    pipe._encode_start_latents = lambda *a: starts.append((a, real_start(*a))) or starts[-1][1]
    pipe.run_text_to_video = lambda *a, **k: seg_latents.append(real_t2v(*a, **k)) \
        or seg_latents[-1]
    reset_counts()
    try:
        videos, secs = timed(lambda: pipe.run_rollouts(["a red fox", "a blue bird"],
                                                       num_rollouts=2,
                                                       num_overlap_frames=OVERLAP_FRAMES))
    finally:
        for name in ("denoise_block", "cache_context_block"):
            delattr(gen, name)
        for name in ("_encode_start_latents", "run_text_to_video"):
            delattr(pipe, name)
    path = all_counts()
    (video1, lat1, ov), start = starts[0]
    boundary = video1.shape[1] - (4 * (OVERLAP_FRAMES - 1) + 1)
    with torch.inference_mode():
        enc_frame = vae.encode(video1[:, boundary:boundary + 1] * 2.0 - 1.0).to(lat1.dtype)
    grounded = (torch.equal(start[:, :1], enc_frame) and torch.equal(start[:, 1:], lat1[:, -2:])
                and torch.equal(seg_latents[1][:, :OVERLAP_FRAMES], start))
    shapes = [tuple(v.shape) for v in videos]
    pix = 1 + 4 * (SEGMENT_FRAMES - 1)
    want_shapes = [(1, pix - (4 * (OVERLAP_FRAMES - 1) + 1), 480, 832, 3), (1, pix, 480, 832, 3)]
    b6 = path.get("halo_conv3d", 0)
    want_b6 = 2 * DECODE_LAUNCHES["halo"]["halo_conv3d"] * (SEGMENT_FRAMES // 3) \
        + ENCODE_CHUNK_CONVS
    print(f"causvid: 2 rollouts {secs:.3f} s, pixel shapes after the trim {shapes}; segment "
          f"2 starts from the re-encoded boundary frame and the last 2 latents {grounded}; "
          f"launches a block {blocks[0]} (all {len(blocks)} equal "
          f"{all(b == blocks[0] for b in blocks)}), the carried prefix's forward {ctx}, "
          f"B6 {b6} (want {want_b6}: 30 a decode chunk, 22 at the boundary encode); {smi}",
          flush=True)
    if (blocks != [want_block] * 5 or ctx != [want_ctx] or not grounded
            or shapes != want_shapes or b6 != want_b6
            or not all(torch.isfinite(v).all() and v.min() >= 0 and v.max() <= 1
                       for v in videos)):
        raise AssertionError(f"causvid: launches {blocks} / {ctx} (want {want_block} / "
                             f"{want_ctx}), grounded {grounded}, shapes {shapes}, B6 {b6}")
    del pipe, gen, vae, videos, starts, seg_latents
    torch.cuda.empty_cache()
    phase("causvid", t0)
    return path


def continuous_phase(dev: torch.device, smi: str) -> dict:
    """Phase 20: ContinuousBatcher with W8A8 linears and the int8 KV cache
    over 2 slots. A at step 0, B at step 1, A retired after 3 blocks and C
    admitted into its slot at position 0 while B goes on; then the 12-frame
    ring with 1 sink (last_step): D at step 0 and E at step 1, 5 blocks each,
    both wrapping the ring at their own positions. Each stream against the
    same stream alone at B=1 with the same draws; B2 launches a step."""
    t0 = time.perf_counter()
    path = {}
    feats = {p: StandInTextEncoder(dev)([p]) for p in ("a red fox", "a blue bird")}

    def setup(cfg, batch, prompts):
        cfg.runtime.batch_size = batch
        gen = SemiARGenerator(cfg, params, device=dev)
        b = ContinuousBatcher(gen)
        b.set_conditioning(gen.encode_text_context(torch.cat([feats[p] for p in prompts])))
        return b

    def drive(cfg, script, prompts):
        """script: per step, the (id, frames, seed) admitted and the ids
        retired before it. Returns ({id: latents}, {id: slot}, B2 a step)."""
        b = setup(cfg, 2, prompts)
        per_step, outs, slots = [], {}, {}
        for admit, retire in script:
            for rid in retire:
                outs[rid] = torch.cat(b.retire(rid).outputs, dim=1)
            for rid, frames, seed in admit:
                slots[rid] = b.admit(rid, frames, seed).slot
            before = all_counts()
            b.step()
            diff = count_diff(all_counts(), before)
            add_counts(path, diff)
            per_step.append(diff.get("flash_attention_prefix_quant", 0))
        for rid in list(b.streams):
            outs[rid] = torch.cat(b.retire(rid).outputs, dim=1)
        return outs, slots, per_step

    def solo(cfg, frames, seed, prompt):
        b = setup(cfg, 1, [prompt])
        b.admit("solo", frames, seed)
        for _ in range(frames // 3):
            b.step()
        return torch.cat(b.streams["solo"].outputs, dim=1)

    base = kv_path_config("int8_b2")
    g = torch.Generator(device=dev).manual_seed(20)
    params = quantize_params(init_params(base.model, g, device=dev), base.quant)
    prompts = ["a red fox", "a blue bird"]  # slot 0, slot 1
    cases = {
        "admit_retire": (base, [([("A", 9, 1)], []), ([("B", 9, 2)], []), ([], []),
                                ([("C", 9, 3)], ["A"]), ([], []), ([], [])]),
        "ring": (kv_path_config("window"), [([("D", 15, 4)], []), ([("E", 15, 5)], [])]
                 + [([], [])] * 4),
    }
    worst = 0.0
    for name, (cfg, script) in cases.items():
        forwards = len(cfg.runtime.denoising_step_list) + (cfg.runtime.context_mode == "rerun")
        (outs, slots, per_step), secs = timed(lambda: drive(cfg, script, prompts))
        errs, equal = {}, {}
        for rid, out in outs.items():
            frames, seed = next((f, s) for adm, _ in script for r_, f, s in adm if r_ == rid)
            ref = solo(cfg, frames, seed, prompts[slots[rid]])
            errs[rid], equal[rid] = rel_err(out, ref), torch.equal(out, ref)
        worst = max(worst, *errs.values())
        want = cfg.model.num_layers * forwards
        print(f"continuous {name}: {len(script)} steps at B=2 {secs:.3f} s, B2 launches a "
              f"step {per_step} (want {want}), slots {slots}; each stream against itself "
              f"alone at B=1: rel err {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
              f"(tol {STREAM_RTOL:g}), bit-equal {equal}; {smi}", flush=True)
        if per_step != [want] * len(script) or not all(v <= STREAM_RTOL for v in errs.values()):
            raise AssertionError(f"continuous {name}: launches {per_step} (want {want}) or a "
                                 f"stream moved by its neighbours {errs}")
    del params
    torch.cuda.empty_cache()
    phase("continuous", t0)
    return path


def i2v_params(cfg: EngineConfig, g: torch.Generator, dev: torch.device):
    """The I2V-14B tree in W8A8, drawn and quantized layer by layer (never
    all in bf16): q/k/v fused and every int8 weight in the GEMM's layout, so
    the generator copies nothing."""
    m = cfg.model
    params = init_params(dataclasses.replace(m, num_layers=0), g, device=dev)
    stacked = None
    for layer in range(m.num_layers):
        blk = to_kernel_layout(fuse_qkv_params(quantize_params(
            {"blocks": init_block_params(m, g, 1, device=dev)}, cfg.quant)))["blocks"]
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty_strided(
                (m.num_layers, *a.shape[1:]), (a[0].numel(), *a.stride()[1:]),
                dtype=a.dtype, device=dev), blk)
        tree_map(lambda dst, src: dst[layer].copy_(src[0]), stacked, blk)
    params["blocks"] = stacked
    return params


def i2v_kernel_cases(dev: torch.device) -> None:
    """B3, B4 and B5 against their plain versions at the I2V-14B shapes
    (K, N of 5120 / 13824 / 15360, M of a block, the text and the CLIP
    tokens), and B1 with 40 heads."""
    d, f = I2V_14B["dim"], I2V_14B["ffn_dim"]
    g = torch.Generator(device=dev).manual_seed(211)
    failed = []
    for nm, m_, k, n in (("qkv", SQ, d, 3 * d), ("o", SQ, d, d), ("fc1", SQ, d, f),
                         ("fc2", SQ, f, d), ("k_img", 257, d, d), ("text_k", TEXT, d, d)):
        check_gemm_plan(m_, n, "int8")
        x, w, xs, ws, b = path_gemm_operands(dev, g, m_, k, n)
        out = int8_matmul(x, w, xs, ws, bias=b)
        torch.cuda.synchronize()
        err = (out.float() - int8_matmul_reference(x, w, xs, ws, bias=b).float()).abs().max()
        print(f"i2v case int8_matmul {nm} [{m_}x{k}]x[{k}x{n}]: max_abs {err.item():.3e} "
              f"(tol 0)", flush=True)
        if err.item() != 0:
            failed.append(f"int8_matmul {nm}")
    for nm, m_, k, act in (("o_in", SQ, d, None), ("fc2_in_gelu", SQ, f, "gelu"),
                           ("img_tokens", 257, d, None), ("text", TEXT, d, None)):
        x = (torch.randn(m_, k, generator=g, device=dev) * 2).to(torch.bfloat16)
        got = quantize_rows_int8(x, act=act)
        torch.cuda.synchronize()
        ok, _ = check_quant_case(f"i2v quantize_rows_int8 {nm} [{m_}x{k}] act {act} G, "
                                 f"chunks {row_plan(k)}", got,
                                 quantize_rows_int8_reference(x, act), True)
        if not ok:
            failed.append(f"quantize_rows_int8 {nm}")
    x = (torch.randn(1, SQ, d, generator=g, device=dev) * 3 + 0.5).to(torch.bfloat16)
    mod = torch.randn(1, 3, 6, d, generator=g, device=dev) * 0.5
    ok, _ = check_quant_case(f"i2v adaln_quantize_rows_int8 [1x{SQ}x{d}] 3 frames",
                             adaln_quantize_rows_int8(x, mod[:, :, 0], mod[:, :, 1]),
                             adaln_quantize_rows_int8_reference(x, mod[:, :, 0], mod[:, :, 1]),
                             False)
    if not ok:
        failed.append("adaln")
    w3 = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    b3 = (0.1 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    x = x.reshape(SQ, d)
    ok, _ = check_quant_case(f"i2v ln_quantize_rows_int8 affine [{SQ}x{d}]",
                             ln_quantize_rows_int8(x, w3, b3),
                             ln_quantize_rows_int8_reference(x, w3, b3), False)
    if not ok:
        failed.append("ln")
    heads = I2V_14B["num_heads"]
    q, k, v = (torch.randn(1, n_, heads, D, generator=g, device=dev).to(torch.bfloat16)
               for n_ in (SQ, 2 * SQ, 2 * SQ))
    out, lse = flash_attention_prefix(q, k, v, 2 * SQ, return_lse=True)
    torch.cuda.synchronize()
    ok, _ = check_attention_case(f"i2v flash_attention_prefix {heads} heads, span {2 * SQ}",
                                 out, lse, *flash_attention_prefix_reference(
                                     q, k, v, 2 * SQ, return_lse=True))
    if not ok:
        failed.append("flash_attention_prefix 40 heads")
    if failed:
        raise AssertionError(f"I2V-14B shapes: {failed} disagree with the plain versions")


def i2v_phase(dev: torch.device, smi: str, clip_features: torch.Tensor) -> dict:
    """Phase 21: the Wan2.1-I2V-14B DiT at full width and depth, W8A8, the
    bf16 21-frame cache: precompute_crossattn_cache with phase 16's CLIP
    features, then I2V_BLOCKS blocks of dit_forward_inference (4 denoise + 1
    context forward each) on 36-channel inputs at 480x832; launches a block,
    the peak memory; one layer and one forward with every kernel against
    every plain version."""
    t0 = time.perf_counter()
    i2v_kernel_cases(dev)
    cfg = main_path_config(I2V_BLOCKS, w8a8=True)
    cfg.model = dataclasses.replace(cfg.model, **I2V_14B)
    m, r = cfg.model, cfg.runtime
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev).manual_seed(21)
    params, build_s = timed(lambda: i2v_params(cfg, g, dev))
    gen = SemiARGenerator(cfg, params, device=dev)
    del params
    weights = memory_bytes(gen.params)
    context = torch.randn(1, m.text_len, m.text_dim, generator=g, device=dev).to(torch.bfloat16)
    reset_counts()
    xattn, text_s = timed(lambda: gen.encode_text_context(context, clip_features))
    text = count_diff(all_counts(), {k: 0 for k in KERNEL_COUNTERS})
    want_text = {"int8_matmul": 4 * m.num_layers, "quantize_rows_int8": 4 * m.num_layers}
    cache = gen.init_cache()
    fpb, fs = m.num_frame_per_block, gen.frame_seq
    shape = (1, fpb, r.latent_height, r.latent_width)
    cond = torch.randn(*shape, I2V_COND, generator=g, device=dev).to(torch.bfloat16)
    steps = gen.denoising_steps
    n = m.num_layers * (len(steps) + 1)
    # B1 twice a layer-forward: the self-attention, and the text
    # cross-attention, whose float32 logits at 40 heads (383 MB) pass
    # cache_attention's 256 MiB limit of the plain path
    want_block = {"int8_matmul": 6 * n, "quantize_rows_int8": 3 * n, "adaln": 2 * n, "ln": n,
                  "flash_attention_prefix": 2 * n}

    def forward(x, t_val, start, need_output=True):
        t = torch.full((1, fpb), t_val, device=dev)
        flow, _ = dit_forward_inference(gen.params, gen.statics, gen.rope_tables,
                                        torch.cat([x, cond], dim=-1), t, xattn, cache, start,
                                        need_output=need_output)
        return flow, t

    per_block, secs, outs = [], [], []
    with torch.inference_mode():
        for bi in range(I2V_BLOCKS):
            before = all_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            start = bi * fpb * fs
            x = torch.randn(*shape, r.latent_channels, generator=g, device=dev).to(torch.bfloat16)
            for i, t_val in enumerate(steps):   # SemiARGenerator.denoise_block's loop
                flow, t = forward(x, t_val, start)
                x0 = gen.schedule.flow_to_x0(flow, x, t)
                if i < len(steps) - 1:
                    fresh = torch.randn(x0.shape, generator=g, device=dev).to(x0.dtype)
                    x = gen.schedule.add_noise(x0, fresh, torch.full_like(t, steps[i + 1]))
            forward(x0, gen.context_noise, start, need_output=False)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            per_block.append(count_diff(all_counts(), before))
            outs.append(x0)
    peak = torch.cuda.max_memory_allocated(dev)
    path = count_diff(all_counts(), {k: 0 for k in all_counts()})
    latents = torch.cat(outs, dim=1)
    print(f"i2v-14B: W8A8 tree built layer by layer in {build_s:.3f} s ({weights / 2**30:.3f} "
          f"GiB), text + CLIP K/V {text_s:.3f} s (launches {text}), s/block "
          f"{', '.join(f'{x:.3f}' for x in secs)}, launches a block {per_block[0]}, latents "
          f"{tuple(latents.shape)}, peak device bytes {peak}; {smi}", flush=True)
    if (per_block != [want_block] * I2V_BLOCKS or text != want_text
            or not torch.isfinite(latents).all() or xattn.k_img is None
            or tuple(xattn.k_img.shape) != (m.num_layers, 1, 257, m.num_heads, m.head_dim)):
        raise AssertionError(f"i2v-14B: launches {per_block} (want {want_block}), text "
                             f"{text} (want {want_text})")

    # one layer, then one forward, every kernel against every plain version,
    # at the last block's first denoise step
    f0 = (I2V_BLOCKS - 1) * fpb
    start = f0 * fs
    geo, spec = gen.statics.geo, gen.statics.spec
    x_blk = torch.cat([outs[-1], cond], dim=-1)
    t = torch.full((1, fpb), steps[0], device=dev)
    with torch.inference_mode():
        tokens = patch_embed(gen.params, m, x_blk)
        _, e0 = time_embeddings(gen.params, m, t)
        angles = rope_angles(gen.rope_tables, fpb, geo.grid_h, geo.grid_w, f0)
        mask = valid_mask(spec, start + geo.tokens, device=dev)
        blk = layer_params(gen.params["blocks"], 0)
        ys, flows = [], []
        for plain in (False, True):
            before = all_counts()
            with plain_versions() if plain else contextlib.nullcontext():
                lc = (cache.k[0].clone(), cache.v[0].clone())
                y, _ = block_forward(blk, m, spec, tokens, e0, angles, lc, xattn.k[0],
                                     xattn.v[0], start, mask,
                                     xattn_img=(xattn.k_img[0], xattn.v_img[0]))
                flow, _ = dit_forward_inference(gen.params, gen.statics, gen.rope_tables,
                                                x_blk, t, xattn, cache, start)
            if plain and all_counts() != before:
                raise AssertionError("a plain-version run launched a kernel")
            ys.append(y)
            flows.append(flow)
        layer_err = rel_err(ys[0] - tokens, ys[1] - tokens)
        fwd_err = rel_err(flows[0], flows[1])
    print(f"i2v-14B block_forward kernels vs plain: update rel err {layer_err:.3e} (tol "
          f"{W8A8_LAYER_RTOL:g}); dit_forward_inference: flow rel err {fwd_err:.3e} (tol "
          f"{W8A8_FORWARD_RTOL:g})", flush=True)
    if not (layer_err <= W8A8_LAYER_RTOL and fwd_err <= W8A8_FORWARD_RTOL):
        raise AssertionError("the I2V-14B path with its kernels disagrees with the plain versions")
    del gen, cache, xattn
    torch.cuda.empty_cache()
    phase("i2v-14B", t0)
    return path


# --- phases 22-25: weights from files, the whole-clip forwards, resume, the CLI

CKPT_BLOCKS = 2          # phase 22: blocks of the pipeline loaded from the .pt
UMT5_FILE_LAYERS = 2     # phase 22: UMT5-XXL width, its depth cut to 2 of 24 layers
UMT5_SHARDS = 3
CLIP_FRAMES = 21         # phase 23: the whole clip, 21 latent frames (32760 tokens)
PLAIN_ROWS = 2048        # query rows a chunk of the plain attention over the clip
RESUME_LAYERS, RESUME_FRAMES, RESUME_BLOCKS = 6, 6, 4  # phase 24: 6 of 30 layers
CLI_FRAMES = 6           # phase 25: latent frames of the self-forcing command
CLI_PROMPT = "a scenic mountain valley"  # the CLI's default prompt
_SAFETENSORS_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
                      torch.int8: "I8", torch.uint8: "U8", torch.int32: "I32",
                      torch.int64: "I64", torch.float8_e4m3fn: "F8_E4M3"}


def since_reset() -> dict:
    """The launches since the last reset_counts(), by kernel (zeros left out)."""
    return count_diff(all_counts(), {k: 0 for k in KERNEL_COUNTERS})


def gate(ok: bool, msg: str) -> None:
    """A check of phases 22-25: raise when it fails."""
    if not ok:
        raise AssertionError(msg)


def host_copy(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu").contiguous()


def reference_state_dict(params: dict, m) -> dict:
    """The DiT tree -> the reference `CausalWanModel` state dict on the host
    (this script's own inverse of `convert_causal_wan_state_dict`: Linear
    [out, in], the patch Conv3d [dim, in, pt, ph, pw], one key a layer)."""
    sd = {}

    def lin(name, p, i=None):
        w, b = (p["w"], p["b"]) if i is None else (p["w"][i], p["b"][i])
        sd[f"{name}.weight"], sd[f"{name}.bias"] = host_copy(w.t()), host_copy(b)

    pt, ph, pw = m.patch_size
    pe = params["patch_embedding"]
    sd["patch_embedding.weight"] = host_copy(
        pe["w"].reshape(pt, ph, pw, m.in_dim, m.dim).permute(4, 3, 0, 1, 2))
    sd["patch_embedding.bias"] = host_copy(pe["b"])
    for name, key in (("text_embedding.0", ("text_embedding", "fc1")),
                      ("text_embedding.2", ("text_embedding", "fc2")),
                      ("time_embedding.0", ("time_embedding", "fc1")),
                      ("time_embedding.2", ("time_embedding", "fc2")),
                      ("head.head", ("head", "head"))):
        lin(name, params[key[0]][key[1]])
    lin("time_projection.1", params["time_projection"])
    sd["head.modulation"] = host_copy(params["head"]["modulation"][None])
    blocks = params["blocks"]
    for i in range(m.num_layers):
        p = f"blocks.{i}"
        for kind in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                lin(f"{p}.{kind}.{n}", blocks[kind][n], i)
            for n in ("norm_q", "norm_k"):
                sd[f"{p}.{kind}.{n}.weight"] = host_copy(blocks[kind][n]["w"][i])
        sd[f"{p}.norm3.weight"] = host_copy(blocks["norm3"]["w"][i])
        sd[f"{p}.norm3.bias"] = host_copy(blocks["norm3"]["b"][i])
        lin(f"{p}.ffn.0", blocks["ffn"]["fc1"], i)
        lin(f"{p}.ffn.2", blocks["ffn"]["fc2"], i)
        sd[f"{p}.modulation"] = host_copy(blocks["modulation"][i][None])
    return sd


def reference_vae_state_dict(params: dict) -> dict:
    """The VAE tree -> the reference `WanVAE_` state dict on the host (this
    script's own inverse of `convert_wan_vae_state_dict`: Conv3d
    [out, in, kt, kh, kw]; the resample and attention convs Conv2d)."""
    sd = {}

    def conv(prefix, p, two_d=False):
        w = p["w"]
        sd[f"{prefix}.weight"] = host_copy(w[0].permute(3, 2, 0, 1) if two_d
                                           else w.permute(4, 3, 0, 1, 2))
        sd[f"{prefix}.bias"] = host_copy(p["b"])

    def gamma(prefix, p):
        sd[f"{prefix}.gamma"] = host_copy(p["gamma"].reshape(-1, 1, 1))

    def res(prefix, p):
        gamma(f"{prefix}.residual.0", p["norm1"])
        conv(f"{prefix}.residual.2", p["conv1"])
        gamma(f"{prefix}.residual.3", p["norm2"])
        conv(f"{prefix}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv(f"{prefix}.shortcut", p["shortcut"])

    def tower(prefix, t, samples):
        conv(f"{prefix}.conv1", t["conv1"])
        for idx, item in enumerate(t[samples]):
            (key, p), = item.items()
            if key == "res":
                res(f"{prefix}.{samples}.{idx}", p)
            else:
                conv(f"{prefix}.{samples}.{idx}.resample.1", p["conv"], two_d=True)
                if "time_conv" in p:
                    conv(f"{prefix}.{samples}.{idx}.time_conv", p["time_conv"])
        mid = t["middle"]
        res(f"{prefix}.middle.0", mid["res1"])
        gamma(f"{prefix}.middle.1.norm", mid["attn"]["norm"])
        conv(f"{prefix}.middle.1.to_qkv", mid["attn"]["qkv"], two_d=True)
        conv(f"{prefix}.middle.1.proj", mid["attn"]["proj"], two_d=True)
        res(f"{prefix}.middle.2", mid["res2"])
        gamma(f"{prefix}.head.0", t["head_norm"])
        conv(f"{prefix}.head.2", t["head_conv"])

    tower("encoder", params["encoder"], "downsamples")
    tower("decoder", params["decoder"], "upsamples")
    conv("conv1", params["conv1"])
    conv("conv2", params["conv2"])
    return sd


def umt5_hf_state_dict(params: dict, cfg: UMT5Config) -> dict:
    """The UMT5 tree -> an HF `UMT5EncoderModel` state dict on the host
    (Linear [out, in], one relative-bias table a layer)."""
    sd = {"shared.weight": host_copy(params["token_embedding"]),
          "encoder.final_layer_norm.weight": host_copy(params["norm"]["w"])}
    b = params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        att = f"{pre}.layer.0.SelfAttention"
        sd[f"{pre}.layer.0.layer_norm.weight"] = host_copy(b["norm1"]["w"][i])
        sd[f"{pre}.layer.1.layer_norm.weight"] = host_copy(b["norm2"]["w"][i])
        for n in ("q", "k", "v", "o"):
            sd[f"{att}.{n}.weight"] = host_copy(b["attn"][n]["w"][i].t())
        sd[f"{att}.relative_attention_bias.weight"] = host_copy(b["pos_emb"][i])
        for n, key in (("wi_0", "gate"), ("wi_1", "fc1"), ("wo", "fc2")):
            sd[f"{pre}.layer.1.DenseReluDense.{n}.weight"] = host_copy(b["ffn"][key]["w"][i].t())
    return sd


def write_safetensors(path: str, tensors: dict) -> int:
    """This script's own writer of the safetensors format (an 8-byte
    little-endian header length, the JSON header padded with spaces to a
    multiple of 8, then each tensor's bytes in key order). Returns the
    file's bytes."""
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for name in sorted(tensors):
            f.write(tensors[name].contiguous().view(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def tree_leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def loader_dtype(path: str, ndim: int) -> torch.dtype:
    """The JAX loader's policy under bf16 (`inferix_tpu/utils/checkpoint.py:
    166-205`), restated: float32 for the time embedding, its projection, the
    modulation and every one-axis leaf; bf16 for the rest."""
    if "time_" in path or "modulation" in path or ndim < 2:
        return torch.float32
    return torch.bfloat16


def gb_per_s(nbytes: int, secs: float) -> str:
    return f"{nbytes / 1e9:.3f} GB in {secs:.3f} s ({nbytes / 1e9 / secs:.3f} GB/s)"


def files_config(model_path: str = None) -> EngineConfig:
    """Phase 22's pipeline: Wan2.1-T2V-1.3B at full width and depth, W8A8
    linears, the bf16 KV cache, CKPT_BLOCKS blocks, no decode."""
    cfg = main_path_config(CKPT_BLOCKS, w8a8=True)
    cfg.model_path = model_path
    cfg.runtime.decode_mode = DecodeMode.NO_DECODE
    return cfg


def files_phase(dev: torch.device, smi: str, ckpt_dir: str) -> tuple:
    """Phase 22: checkpoint files. Phase 4's seeded bf16 tree written as a
    reference-format `{"generator_ema": sd}` .pt in ckpt_dir (kept for
    phase 25) and read back by `load_self_forcing_checkpoint`; the pipeline
    with model_path under W8A8 against the same pipeline given the in-memory
    conversion; the default VAEConfig VAE as a .pth through `load_wan_vae`
    (halo); a UMT5-XXL-width tower in 3 HF safetensors shards through
    `load_sharded_safetensors` and `WanTextEncoder`. Returns (the seeded
    tree, the launches of the phase's own runs)."""
    t0 = time.perf_counter()
    cfg = files_config()
    m = cfg.model
    usage = shutil.disk_usage(ckpt_dir)
    print(f"files: writing under a temporary directory with {usage.free / 1e9:.1f} GB free",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)  # phase 4's tree
    params = init_params(m, g, device=dev, dtype=torch.bfloat16)
    sd = reference_state_dict(params, m)
    pt_path = os.path.join(ckpt_dir, "self_forcing_dmd.pt")
    _, write_s = timed(lambda: torch.save({"generator_ema": sd}, pt_path))
    pt_bytes = os.path.getsize(pt_path)
    loaded, load_s = timed(lambda: load_self_forcing_checkpoint(ckpt_dir, m, device=dev))
    want = dict(tree_leaves_with_paths(params))
    got = dict(tree_leaves_with_paths(loaded))
    values_equal = sorted(got) == sorted(want) and all(
        torch.equal(got[k].float(), want[k].float()) for k in want)
    bad_dtypes = [k for k, v in got.items() if v.dtype != loader_dtype(k, v.dim())]
    f32_leaves = sorted(k for k, v in got.items() if v.dtype == torch.float32)
    print(f"files: DiT .pt written {gb_per_s(pt_bytes, write_s)}, read and converted to "
          f"the card {gb_per_s(pt_bytes, load_s)}; {len(got)} leaves bit-equal to the "
          f"seeded tree {values_equal}, float32 leaves {f32_leaves}, leaves off the JAX "
          f"loader's dtype policy {bad_dtypes}; {smi}", flush=True)
    gate(values_equal and not bad_dtypes,
         "the DiT loaded from the .pt differs from the seeded tree")
    del loaded, got

    # the pipeline from the file against the pipeline given the in-memory
    # conversion of the same state dict
    path = {}
    pipe = SelfForcingPipeline(files_config(ckpt_dir), device=dev)
    _, setup_s = timed(pipe.setup)
    gen = pipe.generator
    want_block = w8a8_block_launches(gen, False)
    want_text = {"int8_matmul": 2 * m.num_layers, "quantize_rows_int8": 2 * m.num_layers}
    reset_counts()
    marks, per_block = [all_counts()], []

    def on_block(x0, bi):
        marks.append(all_counts())
        per_block.append(count_diff(marks[-1], marks[-2]))

    lat_file, run_s = timed(lambda: pipe.run_text_to_video(["a red fox"],
                                                           block_callback=on_block))
    add_counts(path, since_reset())
    del pipe, gen
    torch.cuda.empty_cache()
    mem = SelfForcingPipeline(files_config(), params=convert_causal_wan_state_dict(
        sd, m, device=dev), device=dev)
    lat_mem = mem.run_text_to_video(["a red fox"])
    del mem
    equal = torch.equal(lat_file, lat_mem)
    want = [{k: v + want_text.get(k, 0) for k, v in want_block.items()}] \
        + [want_block] * (CKPT_BLOCKS - 1)
    print(f"files: SelfForcingPipeline(model_path) W8A8 setup (load + quantize) "
          f"{setup_s:.3f} s, {CKPT_BLOCKS} blocks {run_s:.3f} s, latents "
          f"{tuple(lat_file.shape)} bit-equal to the pipeline given params= {equal}; "
          f"launches a block {per_block}; {smi}", flush=True)
    gate(equal and per_block == want, f"the pipeline from the file differs (equal {equal}) "
         f"or its launches {per_block} are not {want}")
    del sd
    torch.cuda.empty_cache()

    # the VAE: a .pth of the default VAEConfig, decoded with the halo impl
    vcfg = VAEConfig()
    vparams = init_vae_params(vcfg, torch.Generator(device=dev).manual_seed(22), dev)
    vsd = reference_vae_state_dict(vparams)
    del vparams
    pth = os.path.join(ckpt_dir, "vae", "Wan2.1_VAE.pth")
    os.makedirs(os.path.dirname(pth))
    _, vwrite_s = timed(lambda: torch.save(vsd, pth))
    pth_bytes = os.path.getsize(pth)
    vae_file, vload_s = timed(lambda: load_wan_vae(pth, vcfg, dtype=torch.bfloat16,
                                                   device=dev, conv_impl="halo"))
    vae_mem = CausalVAE(vcfg, params=convert_wan_vae_state_dict(vsd, vcfg, dev),
                        dtype=torch.bfloat16, device=dev, conv_impl="halo")
    latents = lat_file.to(torch.bfloat16)
    reset_counts()
    with torch.inference_mode():
        video_file, dec_s = timed(lambda: vae_file.decode(latents))
        b6 = all_counts()["halo_conv3d"]
        video_mem = vae_mem.decode(latents)
    add_counts(path, {"halo_conv3d": b6})
    vequal = torch.equal(video_file, video_mem)
    want_b6 = DECODE_LAUNCHES["halo"]["halo_conv3d"] * -(-latents.shape[1] // 3)
    print(f"files: VAE .pth written {gb_per_s(pth_bytes, vwrite_s)}, load_wan_vae (halo, "
          f"bf16) {gb_per_s(pth_bytes, vload_s)}; decode {tuple(video_file.shape)} "
          f"{dec_s:.3f} s, bit-equal to the VAE from the in-memory tree {vequal}, B6 {b6} "
          f"(want {want_b6}); {smi}", flush=True)
    gate(vequal and b6 == want_b6, "the VAE from the .pth differs, or its B6 launches")
    del vae_file, vae_mem, video_file, video_mem, vsd
    shutil.rmtree(os.path.dirname(pth))

    # UMT5-XXL width, 2 layers, in 3 HF safetensors shards
    ucfg = dataclasses.replace(UMT5Config(), num_layers=UMT5_FILE_LAYERS)
    uparams = init_umt5_params(ucfg, torch.Generator(device=dev).manual_seed(23), device=dev)
    hf = umt5_hf_state_dict(uparams, ucfg)
    shard_dir = os.path.join(ckpt_dir, "umt5")
    os.makedirs(shard_dir)
    keys = sorted(hf, key=lambda k: (not k.startswith("shared"), k))
    groups = [keys[:1], [k for k in keys[1:] if ".block.0." in k],
              [k for k in keys[1:] if ".block.0." not in k]]
    t1 = time.perf_counter()
    st_bytes = sum(write_safetensors(
        os.path.join(shard_dir, f"model-{i + 1:05d}-of-{UMT5_SHARDS:05d}.safetensors"),
        {k: hf[k] for k in grp}) for i, grp in enumerate(groups))
    st_write_s = time.perf_counter() - t1
    del hf
    uloaded, st_load_s = timed(lambda: convert_t5_encoder_state_dict(
        load_sharded_safetensors(shard_dir), ucfg, device=dev))
    tok = ByteTokenizer()
    with torch.inference_mode():
        f_file = WanTextEncoder(ucfg, params=uloaded, tokenizer=tok, device=dev)(UMT5_PROMPTS)
        f_mem = WanTextEncoder(ucfg, params=uparams, tokenizer=tok, device=dev)(UMT5_PROMPTS)
    leaves_file, leaves_mem = (dict(tree_leaves_with_paths(t)) for t in (uloaded, uparams))
    tree_equal = sorted(leaves_file) == sorted(leaves_mem) and all(
        leaves_file[k].dtype == v.dtype and torch.equal(leaves_file[k], v)
        for k, v in leaves_mem.items())
    fequal = torch.equal(f_file, f_mem)
    print(f"files: UMT5-XXL width, {UMT5_FILE_LAYERS} layers, {UMT5_SHARDS} safetensors "
          f"shards written {gb_per_s(st_bytes, st_write_s)}, load_sharded_safetensors + "
          f"convert_t5_encoder_state_dict to the card {gb_per_s(st_bytes, st_load_s)}; tree "
          f"bit-equal {tree_equal}, WanTextEncoder features {tuple(f_file.shape)} bit-equal "
          f"to the in-memory tower's {fequal}; {smi}", flush=True)
    gate(tree_equal and fequal,
         "the UMT5 tower from the safetensors shards differs")
    del uloaded, uparams, f_file, f_mem
    shutil.rmtree(shard_dir)
    torch.cuda.empty_cache()
    phase("files", t0)
    return params, path


def plain_attention_chunked(q, k, v, kv_mask=None, scale=None):
    """The mask wrapper's plain version, PLAIN_ROWS query rows at a time (a
    prefix span is the same for every query row, so the rows are
    independent): the whole logits at 32760 x 32760 would be ~51 GB."""
    return torch.cat([plain_flash_attention(q[:, i:i + PLAIN_ROWS], k, v, kv_mask, scale)
                      for i in range(0, q.shape[1], PLAIN_ROWS)], dim=1)


def xattn_on_kernel(m, tokens: int) -> bool:
    """Whether `cache_attention` sends the text cross-attention of a forward
    over `tokens` query rows to B1: its float32 logits past 256 MiB."""
    return 4 * m.num_heads * tokens * TEXT > 256 * 2**20


def wholeclip_phase(dev: torch.device, smi: str, params: dict) -> dict:
    """Phase 23: the three whole-clip forwards in bf16 over 21 latent frames
    (32760 tokens) on phase 22's tree: B1 at 32760 query rows over 32760
    keys and the cross-attention call at 512 keys against the plain version,
    one layer against plain attention, the three properties, launches,
    seconds and peak device bytes of each call."""
    t0 = time.perf_counter()
    m, r = EngineConfig().model, EngineConfig().runtime
    g = torch.Generator(device=dev).manual_seed(230)
    context = torch.randn(1, TEXT, m.text_dim, generator=g, device=dev).to(torch.bfloat16)
    shape = (1, CLIP_FRAMES, r.latent_height, r.latent_width, r.latent_channels)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    clean = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    t = torch.full(shape[:2], 500.0, device=dev)
    rope = build_rope_tables(m.head_dim, m.rope_max_seq_len, device=dev)
    fpb = m.num_frame_per_block
    geo = DiTGeometry(CLIP_FRAMES, r.latent_height, r.latent_width, m.patch_size)
    n = m.num_layers
    with torch.inference_mode():
        xattn = precompute_crossattn_cache(params, m, context)
    path, runs = {}, {}

    def run(name, fn, want_b1):
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out, secs = timed(fn)
        launches = since_reset()
        add_counts(path, launches)
        runs[name] = (secs, torch.cuda.max_memory_allocated(dev),
                      launches.get("flash_attention_prefix", 0), want_b1)
        return out

    per_fwd = {clip: n * (1 + xattn_on_kernel(m, geo.tokens if clip else geo.tokens // 7))
               for clip in (True, False)}
    bidir = lambda xx: dit_forward_bidirectional(params, m, rope, xx, t, xattn,
                                                 dtype=torch.bfloat16)
    causal = lambda xx: dit_forward_block_causal(params, m, rope, xx, t, xattn, fpb,
                                                 dtype=torch.bfloat16)
    teacher = lambda cc: dit_forward_teacher_forcing(params, m, rope, x, cc, t, xattn, fpb,
                                                     dtype=torch.bfloat16)
    blocks = CLIP_FRAMES // fpb
    flow = run("bidirectional", lambda: bidir(x), per_fwd[True])
    x_last = x.clone()
    x_last[:, -1] *= -1
    flow_last = run("bidirectional, last frame flipped", lambda: bidir(x_last), per_fwd[True])
    moved = (flow[:, 0].float() - flow_last[:, 0].float()).abs().max().item()
    bc = run("block_causal", lambda: causal(x), blocks * per_fwd[False])
    x_b6 = x.clone()
    x_b6[:, -fpb:] *= -1
    bc6 = run("block_causal, block 6 flipped", lambda: causal(x_b6), blocks * per_fwd[False])
    causal_ok = torch.equal(bc[:, :-fpb], bc6[:, :-fpb]) and not torch.equal(bc[:, -fpb:],
                                                                            bc6[:, -fpb:])
    tf = run("teacher_forcing", lambda: teacher(clean), 2 * blocks * per_fwd[False])
    clean0 = clean.clone()
    clean0[:, :fpb] *= -1
    tf0 = run("teacher_forcing, clean block 0 flipped", lambda: teacher(clean0),
              2 * blocks * per_fwd[False])
    tf_ok = torch.equal(tf[:, :fpb], tf0[:, :fpb]) and not torch.equal(tf[:, fpb:2 * fpb],
                                                                       tf0[:, fpb:2 * fpb])
    for name, (secs, peak, b1, want) in runs.items():
        print(f"wholeclip: {name}: {secs:.3f} s, peak device bytes {peak}, B1 launches {b1} "
              f"(want {want}); {smi}", flush=True)
    shapes_ok = all(tuple(o.shape) == shape and torch.isfinite(o).all()
                    for o in (flow, bc, tf))
    print(f"wholeclip: flows {shape} finite {shapes_ok}; bidirectional frame 0 moved by "
          f"{moved:.3e} when the last frame flipped; block-causal blocks 0-5 bit-equal and "
          f"block 6 moved when block 6's input flipped {causal_ok}; teacher forcing block 0 "
          f"bit-equal and block 1 moved when clean block 0 flipped {tf_ok}", flush=True)
    gate(shapes_ok and moved > 0 and causal_ok and tf_ok
            and all(b1 == want for _, _, b1, want in runs.values()),
         "the whole-clip forwards: a property, a shape or the B1 launches failed")
    del flow_last, bc, bc6, tf, tf0, clean0, x_b6, x_last

    # B1 at the clip's shapes (layer 0 of the bidirectional call) against
    # the plain version, and the layer against the layer with plain attention
    calls = []
    real = attention_mod.flash_attention

    def record(q, k, v, kv_mask=None, scale=None):
        if len(calls) < 2:
            calls.append((q.clone(), k.clone(), v.clone(),
                          None if kv_mask is None else kv_mask.clone()))
        return real(q, k, v, kv_mask=kv_mask, scale=scale)

    spec = KVCacheSpec(num_layers=n, batch=1, max_tokens=geo.tokens, num_kv_heads=m.num_heads,
                       head_dim=m.head_dim, dtype=torch.bfloat16)
    before = all_counts()
    with torch.inference_mode():
        tokens = patch_embed(params, m, x)
        _, e0 = time_embeddings(params, m, t)
        angles = rope_angles(rope, CLIP_FRAMES, geo.grid_h, geo.grid_w, 0)
        mask = valid_mask(spec, geo.tokens, device=dev)
        blk = layer_params(params["blocks"], 0)
        ups = []
        for plain in (False, True):
            lc = tuple(torch.zeros(1, geo.tokens, m.num_heads, m.head_dim,
                                   dtype=torch.bfloat16, device=dev) for _ in range(2))
            with mock.patch.object(attention_mod, "flash_attention",
                                   plain_attention_chunked if plain else record):
                y, _ = block_forward(blk, m, spec, tokens, e0, angles, lc, xattn.k[0],
                                     xattn.v[0], 0, mask)
            ups.append(y - tokens)
        layer_err = rel_err(ups[0], ups[1])
        oks = []
        for label, (q, k, v, kv_mask) in zip(("self-attention", "cross-attention"), calls):
            out, lse = flash_attention_prefix(q, k, v, k.shape[1], return_lse=True)
            refs = [flash_attention_prefix_reference(q[:, i:i + PLAIN_ROWS], k, v, k.shape[1],
                                                     return_lse=True)
                    for i in range(0, q.shape[1], PLAIN_ROWS)]
            ref = torch.cat([a for a, _ in refs], dim=1)
            ref_lse = torch.cat([b for _, b in refs], dim=2)
            oks.append(check_attention_case(
                f"wholeclip: B1 {label} q {tuple(q.shape)} over {k.shape[1]} keys, mask "
                f"{'none' if kv_mask is None else int(kv_mask.sum())}", out, lse, ref,
                ref_lse)[0])
    restore_counts(before)
    print(f"wholeclip: block_forward layer 0 at {geo.tokens} tokens, kernel vs plain "
          f"attention: update rel err {layer_err:.3e} (tol {LAYER_RTOL:g})", flush=True)
    gate(all(oks) and len(calls) == 2 and layer_err <= LAYER_RTOL,
         "B1 at the whole clip's shapes disagrees with its plain version")
    torch.cuda.empty_cache()
    phase("wholeclip", t0)
    return path


def resume_phase(dev: torch.device, smi: str, state_dir: str) -> dict:
    """Phase 24: W8A8 with the int8 KV cache, 6 of 30 layers, a 6-frame
    rolling cache (9360 tokens): RESUME_BLOCKS blocks without a break
    against 2 blocks, save_generation_state (cache, torch.Generator,
    frames_done), load_generation_state and 2 more blocks."""
    t0 = time.perf_counter()
    cfg = main_path_config(RESUME_BLOCKS, w8a8=True)
    m, r, q = cfg.model, cfg.runtime, cfg.quant
    m.num_layers, m.local_attn_size = RESUME_LAYERS, RESUME_FRAMES
    q.quantize_kv_cache, q.kv_cache_dtype = True, "int8"
    g = torch.Generator(device=dev).manual_seed(24)
    params = quantize_params(init_params(m, g, device=dev, dtype=torch.bfloat16), q)
    gen = SemiARGenerator(cfg, params, dtype=torch.bfloat16, device=dev)
    context = torch.randn(1, TEXT, m.text_dim, generator=g, device=dev).to(torch.bfloat16)
    xattn = gen.encode_text_context(context)
    fpb = m.num_frame_per_block
    noise = torch.randn(1, RESUME_BLOCKS * fpb, r.latent_height, r.latent_width,
                        r.latent_channels, generator=g, device=dev).to(torch.bfloat16)
    full, _ = gen.generate(noise, xattn, generator=torch.Generator(device=dev).manual_seed(240))
    reset_counts()
    cache, gb = gen.init_cache(), torch.Generator(device=dev).manual_seed(240)
    outs, launches = [], []

    def block(cache, bi, g):
        before = all_counts()
        x0, cache = gen.denoise_block(cache, xattn, noise[:, bi * fpb:(bi + 1) * fpb],
                                      bi * fpb, generator=g)
        launches.append(count_diff(all_counts(), before))
        outs.append(x0)
        return cache

    half = RESUME_BLOCKS // 2
    for bi in range(half):
        cache = block(cache, bi, gb)
    path_npz = os.path.join(state_dir, "state.npz")
    _, save_s = timed(lambda: save_generation_state(path_npz, cache=cache, generator=gb,
                                                    frames_done=half * fpb))
    del cache, gb
    st, load_s = timed(lambda: load_generation_state(path_npz, device=dev))
    cache2, g2 = KVCache(**st["cache"]), st["generator"]
    for bi in range(st["frames_done"] // fpb, RESUME_BLOCKS):
        cache2 = block(cache2, bi, g2)
    path = since_reset()
    resumed = torch.cat(outs, dim=1)
    equal = torch.equal(resumed, full)
    want_b2 = m.num_layers * (len(gen.denoising_steps) + 1)
    b2 = [c.get("flash_attention_prefix_quant", 0) for c in launches]
    print(f"resume: W8A8 + int8 KV, {m.num_layers} layers, a {RESUME_FRAMES}-frame ring of "
          f"{gen.statics.spec.max_tokens} tokens: {RESUME_BLOCKS} blocks resumed after "
          f"block {half - 1} bit-equal to the run without the break {equal}; "
          f"save_generation_state {save_s:.3f} s ({os.path.getsize(path_npz)} bytes), "
          f"load_generation_state {load_s:.3f} s; B2 a block {b2} (want {want_b2}); {smi}",
          flush=True)
    gate(equal and b2 == [want_b2] * RESUME_BLOCKS,
         "the resumed stream differs from the stream without the break")
    del gen, params, st, cache2, full
    torch.cuda.empty_cache()
    phase("resume", t0)
    return path


# ---------------------------------------------------------------------------
# Phases 26-29: the MAGI-1 DiT (models.magi)
# ---------------------------------------------------------------------------

MAGI_720 = (90, 90)        # 720x720 through the 8x VAE: 45 x 45 patches, 2025 tokens a frame
MAGI_720x1280 = (90, 160)  # 45 x 80 patches, 3600 tokens a frame
MAGI_CT, MAGI_CT_24B = 12150, 21600  # tokens a chunk of 6 frames
# The walk of phases 27-28: magi_4p5b.json's window and kv ranges over 4
# chunks; num_steps 4 where the reference takes 64 (a cut for the script's
# wall): 7 window forwards of 1, 2, 3, 4, 4, 3, 2 chunks (the last three
# with the clean chunk in front), 19 chunk forwards.
MAGI_WALK = dict(chunk_num=4, window_size=4, num_steps=4, chunk_width=6,
                 noise2clean_kvrange=(5, 4, 3, 2), clean_chunk_kvrange=1)
MAGI_WHOLE_AT = 3           # the walk's 4-chunk window, also run as one whole-window forward
MAGI_CAPTION_TOKENS = 300   # valid tokens of the prompt's caption mask (of 800)
MAGI_NULL_TOKENS = 50       # the null caption's mask (the reference's 50 tokens)
# The whole-window forward against the per-chunk walk at the same step: the
# same math with other GEMM shapes (M 48600 against 12150), so other bf16
# summation orders and roundings, carried through 34 bf16 layers: the
# reasoning of FORWARD_RTOL.
MAGI_WINDOW_RTOL = FORWARD_RTOL
# W8A8 against bf16 (the same seeded weights): per-channel int8 weights and
# per-token int8 activations put ~0.4% of quantization noise into each of the
# 8 linears of a layer (a step is 1/127 of the row's or column's absmax);
# through 34 layers and 4 Euler steps the velocities move by a few percent
# (3.2e-2 at the first step to 5.8e-2 at the last on an H100): each step's
# velocity within MAGI_W8A8_RTOL in norm of the bf16 walk's.
MAGI_W8A8_RTOL = 0.1
# The int8 or e4m3 window cache against the bf16 one, both W8A8: K/V
# rounded to 1/127 of each (token, head) row's absmax, or to e4m3's 3 bits
# of mantissa (2^-4 relative), on every attention read (2.2e-2 to 3.1e-2
# on an H100).
MAGI_KV_RTOL = 0.1
# The fp8 distill layout's plain e4m3 forward against its int8 requant
# (tests/test_magi_torch_parity.py::test_magi_pipeline_int8_requant_tracks_fp8).
MAGI_FP8_RTOL = 0.05
MAGI_FP8_LAYERS = 3         # the fp8 layout at full width: bf16 first, e4m3 middle, bf16 last
MAGI_DISTILL_DT = 8.0       # distill_dt_factor of a 16-step distilled schedule (16 / 4 * 2)
MAGI_24B_LAYERS = 4         # of 48: the 24B widths' depth cut for the script's wall


def magi_config(name: str) -> MagiModelConfig:
    """The model block of examples/configs/magi_<name>.json."""
    with open(os.path.join(REPO, "examples", "configs", f"magi_{name}.json")) as f:
        return MagiModelConfig(**json.load(f)["model"])


def gqa_plain(q, k, v, kv_len, kv_start=0, k_scale=None, v_scale=None):
    """The GQA fold over the plain versions of B1 / B2, PLAIN_ROWS folded
    rows at a time (the rows of a span are independent)."""
    rows = gqa_fold(q, k.shape[2])
    if k_scale is None:
        ref = lambda r: flash_attention_prefix_reference(r, k, v, kv_len, kv_start)  # noqa: E731
    else:
        ref = lambda r: flash_attention_prefix_quant_reference(  # noqa: E731
            r, k, v, k_scale, v_scale, kv_len, kv_start)
    out = torch.cat([ref(rows[:, i:i + PLAIN_ROWS]) for i in range(0, rows.shape[1], PLAIN_ROWS)],
                    dim=1)
    return gqa_unfold(out, q.shape[1])


def check_out_case(label: str, out, ref) -> tuple:
    """check_attention_case's per-element rule without an lse."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    rms = ref.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
    bound = ATTN_TOL * (ref.abs() + rms)
    share = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0)).max().item()
    ok = share <= 1 and torch.isfinite(out).all().item()
    print(f"{label}: max_abs {diff.max().item():.3e} max |diff|/({ATTN_TOL:g}*(|ref|+rms)) "
          f"{share:.3f} (tol 1) {'ok' if ok else 'FAIL'}", flush=True)
    return ok, diff.max().item()


def gqa_bound(sq: int, hq: int, hkv: int, spans, kv_bytes: float = 2.0):
    """(bound_ms, bound_by) of GQA attention of sq query rows a batch row
    over each row's live span: 4 sq hq D span operations at the bf16 peak;
    q read and the output written once, each live K/V row read once a kv
    head (kv_bytes an element, the int8 scales included)."""
    flops = 4.0 * sq * hq * D * sum(spans)
    nbytes = 2 * 2.0 * len(spans) * sq * hq * D + 2.0 * sum(spans) * hkv * D * kv_bytes
    return bound_of(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3)


# (name, M, K, N) of the MAGI linears: 4.5B at M = one chunk (12150 tokens),
# the caption K/V at M = 4 chunks x 800; 24B widths at M 21600, its caption
# K/V at M = 2 chunks x 800
MAGI_GEMMS = (
    ("4p5b q/qx", MAGI_CT, 3072, 3072), ("4p5b k/v", MAGI_CT, 3072, 1024),
    ("4p5b kv_xattn", 3200, 3072, 2048), ("4p5b proj", MAGI_CT, 6144, 3072),
    ("4p5b fc1", MAGI_CT, 3072, 12288), ("4p5b fc2", MAGI_CT, 12288, 3072),
    ("24b q/qx", MAGI_CT_24B, 6144, 6144), ("24b k/v", MAGI_CT_24B, 6144, 1024),
    ("24b kv_xattn", 1600, 6144, 2048), ("24b proj", MAGI_CT_24B, 12288, 6144),
    ("24b fc1", MAGI_CT_24B, 6144, 32768), ("24b fc2", MAGI_CT_24B, 16384, 6144))
# (name, M, K, act) of the MAGI int8 linears' input quantization
MAGI_QUANTS = (
    ("4p5b ln", MAGI_CT, 3072, None), ("4p5b proj in", MAGI_CT, 6144, None),
    ("4p5b fc2 gelu_exact", MAGI_CT, 12288, "gelu_exact"),
    ("24b ln", MAGI_CT_24B, 6144, None), ("24b proj in", MAGI_CT_24B, 12288, None),
    ("24b fc2 silu_mul", MAGI_CT_24B, 32768, "silu_mul"))


def magi_kernel_phase(dev: torch.device) -> dict:
    """Phase 26: B1 / B2 through the GQA fold, B3 and B4 at the MAGI shapes,
    each against its plain version, then timed beside its bound. Returns
    the worst error of each kernel's cases."""
    g = torch.Generator(device=dev).manual_seed(26)
    before = all_counts()
    failed, worst = [], {"b1": 0.0, "b1_fp8": 0.0, "b2": 0.0, "b3": 0.0, "b4": 0.0}
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def attn_case(name, key, kern, plain, args, sq, hq, hkv, spans, kv_bytes, sdpa=None):
        ok, err = check_out_case(f"magi {name}", kern(*args), plain(*args))
        if not ok:
            failed.append(name)
        worst[key] = max(worst[key], err)
        ms = time_ms(lambda: kern(*args), iters=5, warmup=1)
        bnd, by = gqa_bound(sq, hq, hkv, spans, kv_bytes)
        lib = f", sdpa {time_ms(sdpa, iters=5, warmup=1):.3f} ms" if sdpa else ""
        print(f"magi {name}: {ms:.3f} ms, bound {bnd:.3f} ms ({by}), "
              f"{4 * sq * hq * D * sum(spans) / ms / 1e9:.1f} TFLOP/s{lib}", flush=True)

    # 4.5B self-attention: 24 q heads over 8 kv heads, one chunk's 12150 rows
    # over a 5-chunk cache (the widest noise2clean span); spans as the walk has them
    q = randn(1, MAGI_CT, 24, D)
    k, v = randn(1, 5 * MAGI_CT, 8, D), randn(1, 5 * MAGI_CT, 8, D)
    for s0, s1 in ((0, MAGI_CT), (MAGI_CT, 4 * MAGI_CT), (0, 5 * MAGI_CT)):
        sdpa = None
        if s1 - s0 == 5 * MAGI_CT:  # the library: SDPA over K/V repeated to the q heads
            qt, kt, vt = (x.repeat_interleave(24 // x.shape[2], 2).transpose(1, 2)
                          for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
        attn_case(f"B1 rep 3 span [{s0}, {s1})", "b1", flash_attention_gqa, gqa_plain,
                  (q, k, v, s1, s0), MAGI_CT, 24, 8, [s1 - s0], 2, sdpa)
    k8, v8 = (x.float().clamp(-FP8_MAX, FP8_MAX).to(FP8) for x in (k, v))
    attn_case(f"B1 e4m3 rep 3 span {5 * MAGI_CT}", "b1_fp8", flash_attention_gqa, gqa_plain,
              (q, k8, v8, 5 * MAGI_CT, 0), MAGI_CT, 24, 8, [5 * MAGI_CT], 1)
    del k8, v8
    kq, ks = quantize_kv_block(k)
    vq, vs = quantize_kv_block(v)
    attn_case(f"B2 rep 3 span {5 * MAGI_CT}", "b2", flash_attention_gqa_quant,
              lambda q_, k_, v_, ks_, vs_, e, s: gqa_plain(q_, k_, v_, e, s, ks_, vs_),
              (q, kq, vq, ks, vs, 5 * MAGI_CT, 0), MAGI_CT, 24, 8, [5 * MAGI_CT], 1 + 4 / D)
    del q, k, v, kq, vq, ks, vs
    # the caption cross-attention: 4 chunk rows over 800 caption keys, per-row
    # kv_len (prefix masks), K LayerNormed (contiguous), V a strided slice of kv_y
    qx = randn(4, MAGI_CT, 24, D)
    kv_y = randn(4, 800, 8, 2 * D)
    yk, yv = kv_y[..., :D].contiguous(), kv_y[..., D:]
    lens = torch.tensor([800, MAGI_CAPTION_TOKENS, MAGI_NULL_TOKENS, 1], dtype=torch.int32,
                        device=dev)
    attn_case("B1 cross rep 3, 800 caption keys, kv_len [800, 300, 50, 1], strided V", "b1",
              flash_attention_gqa, gqa_plain, (qx, yk, yv, lens, 0), MAGI_CT, 24, 8,
              lens.tolist(), 2)
    del qx, kv_y, yk, yv
    # 24B: 48 q heads over 8 kv heads (rep 6), 21600 rows over a 4-chunk span
    q = randn(1, MAGI_CT_24B, 48, D)
    k, v = randn(1, 4 * MAGI_CT_24B, 8, D), randn(1, 4 * MAGI_CT_24B, 8, D)
    attn_case(f"B1 rep 6 span {4 * MAGI_CT_24B}", "b1", flash_attention_gqa, gqa_plain,
              (q, k, v, 4 * MAGI_CT_24B, 0), MAGI_CT_24B, 48, 8, [4 * MAGI_CT_24B], 2)
    kq, ks = quantize_kv_block(k)
    vq, vs = quantize_kv_block(v)
    del k, v
    attn_case(f"B2 rep 6 span {4 * MAGI_CT_24B}", "b2", flash_attention_gqa_quant,
              lambda q_, k_, v_, ks_, vs_, e, s: gqa_plain(q_, k_, v_, e, s, ks_, vs_),
              (q, kq, vq, ks, vs, 4 * MAGI_CT_24B, 0), MAGI_CT_24B, 48, 8,
              [4 * MAGI_CT_24B], 1 + 4 / D)
    del q, kq, vq, ks, vs
    torch.cuda.empty_cache()

    # B3 at every MAGI linear, no bias (the MAGI int8 linear adds none)
    for name, m, k_, n in MAGI_GEMMS:
        x_q, w_q, xs, ws, _ = path_gemm_operands(dev, g, m, k_, n)
        check_gemm_plan(m, n, "int8")
        got = int8_matmul(x_q, w_q, xs, ws, torch.bfloat16)
        want = int8_matmul_reference(x_q, w_q, xs, ws, torch.bfloat16)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.equal(got, want)
        worst["b3"] = max(worst["b3"], err)
        del want
        ms = time_ms(lambda: int8_matmul(x_q, w_q, xs, ws, torch.bfloat16), iters=5, warmup=1)
        bnd, by = bound_of(*gemm_times(m, k_, n))
        print(f"magi B3 {name} [{m} x {k_}] x [{k_} x {n}]: bit-equal "
              f"{'ok' if ok else 'FAIL'}, {ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
              f"{gemm_rate('int8', m, k_, n, ms, bnd)}", flush=True)
        if not ok:
            failed.append(name)
        del x_q, w_q, xs, ws, got
        torch.cuda.empty_cache()

    # B4 at every MAGI int8 linear's input, with fc2's folded activation
    for name, m, k_, act in MAGI_QUANTS:
        x = (torch.randn(m, k_, generator=g, device=dev) * 2).to(bf)
        ok, err = check_quant_case(f"magi B4 {name}", quantize_rows_int8(x, act),
                                   quantize_rows_int8_reference(x, act), exact=True)
        worst["b4"] = max(worst["b4"], err)
        if not ok:
            failed.append(name)
        k_out = k_ // 2 if act == "silu_mul" else k_
        ms = time_ms(lambda: quantize_rows_int8(x, act), iters=5, warmup=1)
        bnd = quant_bound(m, k_, k_out)
        print(f"magi B4 {name} [{m} x {k_}] act {act}: {ms:.4f} ms, bound {bnd:.4f} ms "
              f"(bytes), {quant_rate(ms, bnd)}", flush=True)
        del x
    restore_counts(before)
    if failed:
        raise AssertionError(f"MAGI kernel cases failed: {failed}")
    return worst


def magi_captions(params: dict, cfg: MagiModelConfig, dev, g):
    """(caption [1, 800, 4096] bf16 with its prefix mask of
    MAGI_CAPTION_TOKENS, the null caption: the learned table with its
    50-token mask), as the pipeline builds them."""
    cap = torch.randn(1, cfg.caption_max_length, cfg.caption_channels, generator=g,
                      device=dev).to(torch.bfloat16)
    null = params["y_embedder"]["null_caption_embedding"][None].to(torch.bfloat16)
    masks = []
    for n in (MAGI_CAPTION_TOKENS, MAGI_NULL_TOKENS):
        m = torch.zeros(1, cfg.caption_max_length, device=dev)
        m[:, :n] = 1.0
        masks.append(m)
    return cap, masks[0], null, masks[1]


def magi_walk(params, statics, x0, caps, whole_at=None) -> dict:
    """MAGI_WALK's schedule with per-chunk dispatch (`magi_forward_window_scan`),
    as the pipeline walks it: the clean chunk re-forwarded in front of the
    window (null caption, t = clean_t), Euler steps on the denoising chunks.
    At step `whole_at` the window also runs as one whole-window forward
    first (it rewrites every window position before reading it, so the
    per-chunk forward after it sees the walk's own cache). Returns the
    latents, each step's velocity (host, float32), (chunks, seconds) a
    window forward, and the whole-window gate's pair."""
    cfg, spec, geo = statics
    cw, dev = geo.chunk_width, x0.device
    sched = ChunkSchedule(MagiScheduleConfig(**MAGI_WALK))
    cache = init_kv_cache(spec, dev)
    cap, mask, null, null_mask = caps
    drop = torch.tensor([False], device=dev)
    x = x0.clone()
    out = {"vels": [], "secs": []}
    for step in range(sched.total_forward_steps):
        c_start, c_end, _, _ = sched.window(step)
        extra = sched.fwd_extra_1st_chunk(step)
        w0 = c_start - 1 if extra else c_start
        t_vals = sched.timesteps(step)
        if extra:
            t_vals = np.concatenate([[sched.cfg.clean_t], t_vals])
        clean = [extra] + [False] * (c_end - w0 - 1)
        caps_w = torch.stack([null[0] if c else cap[0] for c in clean])[None]
        masks_w = torch.stack([null_mask[0] if c else mask[0] for c in clean])[None]
        t = torch.tensor(np.asarray(t_vals, np.float32)[None], device=dev)
        kvr = sched.kv_ranges(step, include_clean=extra)
        args = (x[:, w0 * cw:c_end * cw], t, caps_w, masks_w, cache, w0, kvr)
        if step == whole_at:
            out["whole"] = magi_forward(params, statics, None, *args,
                                        caption_dropout=drop)[0].float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, cache = magi_forward_window_scan(params, statics, None, *args, caption_dropout=drop)
        torch.cuda.synchronize()
        out["secs"].append((c_end - w0, time.perf_counter() - t0))
        if step == whole_at:
            out["per_chunk"] = v.float()
        if extra:
            v = v[:, cw:]
        n_den = c_end - c_start
        vv = v.float().reshape(1, n_den, cw, *v.shape[2:])
        d = torch.tensor(sched.integrate_deltas(step), dtype=torch.float32,
                         device=dev).reshape(1, -1, 1, 1, 1, 1)
        xd = x[:, c_start * cw:c_end * cw].float().reshape(vv.shape)
        x[:, c_start * cw:c_end * cw] = (xd + vv * d).reshape(
            1, n_den * cw, *x.shape[2:]).to(x.dtype)
        sched.mark_integrated(step)
        out["vels"].append(v.float().cpu())
    out["x"], out["cache"] = x, cache
    return out


def walk_launches(cfg: MagiModelConfig, walk: dict, w8a8: bool, kv: str) -> dict:
    """The launches a walk's code implies, per chunk forward: self-attention
    (B1 over a bf16 cache, B1 e4m3, or B2 over int8) and the caption
    cross-attention (B1) once a layer; under W8A8 8 int8 linears a layer
    (q, k, v, qx, kv_xattn, proj, fc1, fc2), each a B4 and a B3 launch,
    and the int8 cache's K and V writes 2 B4 a layer."""
    n = sum(c for c, _ in walk["secs"]) * cfg.num_layers
    want = {"flash_attention_prefix": n * (1 + (kv == "bf16"))}
    if kv == "e4m3":
        want["flash_attention_prefix_fp8"] = n
    if kv == "int8":
        want["flash_attention_prefix_quant"] = n
    if w8a8 or kv == "int8":
        want["quantize_rows_int8"] = n * (8 * w8a8 + 2 * (kv == "int8"))
    if w8a8:
        want["int8_matmul"] = 8 * n
    if "whole" in walk:  # the whole-window forward: self once a chunk a layer, cross once a layer
        nc = walk["whole_chunks"]
        want["flash_attention_prefix"] += cfg.num_layers * (nc * (kv == "bf16") + 1)
    return want


def step_errors(vels, ref_vels) -> list:
    return [rel_err(a, b) for a, b in zip(vels, ref_vels)]


def magi_4p5b_phase(dev: torch.device, smi: str) -> tuple:
    """Phase 27: MAGI-4.5B at full width and depth in bf16, seeded weights:
    the walk over a bf16 cache of 4 chunks at 720x720, the whole-window
    forward against the per-chunk walk, the 3-CFG batch with
    sync_kv_rows, the uncond forward. Returns (params, walk, inputs,
    launches)."""
    t0 = time.perf_counter()
    cfg = magi_config("4p5b")
    g = torch.Generator(device=dev).manual_seed(27)
    params = init_magi_params(cfg, g, dev)
    caps = magi_captions(params, cfg, dev, g)
    statics = make_magi_statics(cfg, 1, *MAGI_720, MAGI_WALK["chunk_num"])
    cw, ct = statics.geo.chunk_width, statics.geo.chunk_tokens
    x0 = torch.randn(1, MAGI_WALK["chunk_num"] * cw, *MAGI_720, cfg.latent_channels,
                     generator=g, device=dev).to(torch.bfloat16)
    print(f"magi-4.5B: {cfg.num_layers} layers, width {cfg.hidden_size}, "
          f"{cfg.num_attention_heads} q heads over {cfg.num_query_groups}, ffn "
          f"{cfg.ffn_hidden_size}; {memory_bytes(params) / 1e9:.3f} GB of bf16 weights; "
          f"chunk {ct} tokens, cache {statics.spec.max_tokens} tokens "
          f"({kv_cache_bytes(statics.spec) / 1e9:.3f} GB); "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, bf16 reduced-precision "
          f"reduction {torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    reset_counts()
    walk = magi_walk(params, statics, x0, caps, whole_at=MAGI_WHOLE_AT)
    walk["whole_chunks"] = walk["secs"][MAGI_WHOLE_AT][0]
    got = since_reset()
    want = walk_launches(cfg, walk, False, "bf16")
    print(f"magi-4.5B bf16 walk: launches {got} (the code implies {want})", flush=True)
    gate(got == want, "MAGI-4.5B bf16 walk launches")
    err = rel_err(walk["whole"], walk["per_chunk"])
    print(f"magi-4.5B whole-window forward vs the per-chunk walk at step {MAGI_WHOLE_AT} "
          f"({walk['whole_chunks']} chunks): rel err {err:.3e} (tol {MAGI_WINDOW_RTOL:g})",
          flush=True)
    gate(err <= MAGI_WINDOW_RTOL, "whole-window vs per-chunk")
    gate(all(torch.isfinite(v).all() for v in walk["vels"]), "finite velocities")
    for n, s in walk["secs"]:
        print(f"magi-4.5B bf16 window forward of {n} chunks: {s:.3f} s "
              f"({2 * cfg.num_layers} B1 a chunk: {cfg.num_layers} self + "
              f"{cfg.num_layers} cross)", flush=True)
    launches = dict(got)
    x = walk["x"]
    del walk["cache"]
    torch.cuda.empty_cache()

    # the 3-CFG batch: row 0 with the caption, row 1 the null caption with
    # the adaln dropout token; row 1's span persists in both rows
    s2 = make_magi_statics(cfg, 2, *MAGI_720, MAGI_WALK["chunk_num"])
    cache2 = init_kv_cache(s2.spec, dev)
    sched = ChunkSchedule(MagiScheduleConfig(**MAGI_WALK))
    t_vals = torch.tensor(np.asarray(sched.timesteps(MAGI_WHOLE_AT), np.float32), device=dev)
    n = t_vals.shape[0]
    cap, mask, null, null_mask = caps
    caps2 = torch.stack([cap[0].expand(n, -1, -1), null[0].expand(n, -1, -1)])
    masks2 = torch.stack([mask[0].expand(n, -1), null_mask[0].expand(n, -1)])
    x2 = x[:, :n * cw].expand(2, -1, -1, -1, -1).contiguous()
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    v2, cache2 = magi_forward(params, s2, None, x2, t_vals[None].expand(2, -1), caps2, masks2,
                              cache2, 0, sched.kv_ranges(MAGI_WHOLE_AT, False),
                              caption_dropout=torch.tensor([False, True], device=dev),
                              sync_kv_rows=True)
    torch.cuda.synchronize()
    cfg_s = time.perf_counter() - t1
    synced = all(torch.equal(f[:, 0, :n * ct], f[:, 1, :n * ct]) for f in cache2 if f is not None)
    gate(synced and torch.isfinite(v2).all().item(), "3-CFG batch: rows synced, finite")
    del cache2
    xu = x[0, :n * cw].reshape(n, cw, *x.shape[2:])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vu = magi_forward_uncond(params, s2, xu, t_vals[:, None], null.expand(n, -1, -1)[:, None],
                             null_mask.expand(n, -1)[:, None])
    torch.cuda.synchronize()
    unc_s = time.perf_counter() - t1
    gate(tuple(vu.shape) == (n, cw, *MAGI_720, cfg.out_channels)
         and torch.isfinite(vu).all().item(), "uncond forward")
    cfg_launches = since_reset()
    print(f"magi-4.5B 3-CFG batch (B=2, {n} chunks, sync_kv_rows: row 0's span equal to row "
          f"1's bit for bit): {cfg_s:.3f} s; uncond forward of {n} chunk rows: {unc_s:.3f} s; "
          f"launches {cfg_launches}", flush=True)
    add_counts(launches, cfg_launches)
    del v2, vu
    torch.cuda.empty_cache()
    phase("magi-4.5B", t0)
    return params, walk, (x0, caps), launches


def kv_cache_bytes(spec) -> int:
    """The bytes init_kv_cache(spec) allocates: K and V, and the int8
    cache's float32 scales a (token, head)."""
    per_head = spec.head_dim * (1 if spec.quantized else spec.dtype.itemsize) \
        + 4 * spec.quantized
    return 2 * spec.num_layers * spec.batch * spec.max_tokens * spec.num_kv_heads * per_head


def magi_reference_sd(params: dict, cfg: MagiModelConfig, fp8_layers=()) -> dict:
    """This script's inverse of `convert_magi_state_dict`: the stacked tree
    as a reference `VideoDiTModel` state dict on the host; the linears of
    `fp8_layers` in the distill-quant layout (e4m3 [1, out, in] with one
    weight scale; proj and fc2 per-channel with a smooth scale, the others
    per-tensor; input scales 0.02, as tests/test_magi_torch_parity.py's)."""
    sd = {}
    h = lambda x: x.detach().to("cpu").contiguous()  # noqa: E731
    blocks = params["blocks"]

    def lin(name, p, layer=None, bias=False):
        w = p["w"] if layer is None else p["w"][layer]
        sd[f"{name}.weight"] = h(w.t())
        if bias:
            sd[f"{name}.bias"] = h(p["b"] if layer is None else p["b"][layer])

    def fp8_lin(name, w, per_channel):
        wf = w.t().float()
        ws = wf.abs().max() / 448.0
        sd[f"{name}.weight"] = h((wf / ws).to(FP8)[None])
        sd[f"{name}.weight_scale"] = h(ws.reshape(1))
        g = torch.Generator(device=w.device).manual_seed(len(name))
        if per_channel:
            sd[f"{name}.smooth_scale"] = h(
                torch.rand(1, w.shape[0], generator=g, device=w.device) * 0.5 + 0.75)
            sd[f"{name}.input_scale"] = torch.tensor([0.02])
        else:
            sd[f"{name}.input_scale"] = torch.full((w.shape[0],), 0.02)

    def ln(name, p, layer=None):
        sd[f"{name}.weight"] = h(p["w"] if layer is None else p["w"][layer])
        sd[f"{name}.bias"] = h(p["b"] if layer is None else p["b"][layer])

    w = params["x_embedder"]["w"]
    p = cfg.patch_size
    sd["x_embedder.weight"] = h(w.reshape(cfg.t_patch_size, p, p, cfg.in_channels, -1)
                                .permute(4, 3, 0, 1, 2))
    lin("t_embedder.mlp.0", params["t_embedder"]["fc1"], bias=True)
    lin("t_embedder.mlp.2", params["t_embedder"]["fc2"], bias=True)
    ye = params["y_embedder"]
    lin("y_embedder.y_proj_xattn.0", ye["y_proj_xattn"], bias=True)
    lin("y_embedder.y_proj_adaln.0", ye["y_proj_adaln"], bias=True)
    sd["y_embedder.null_caption_embedding"] = h(ye["null_caption_embedding"])
    sd["rope.bands"] = h(params["rope_bands"])
    for i in range(cfg.num_layers):
        pre = f"videodit_blocks.layers.{i}"
        att = f"{pre}.self_attention"
        ln(f"{att}.linear_qkv.layer_norm", blocks["ln_qkv"], i)
        for name, key, per_channel in (("linear_qkv.q", "q", False), ("linear_qkv.qx", "qx", False),
                                       ("linear_qkv.k", "k", False), ("linear_qkv.v", "v", False),
                                       ("linear_proj", "proj", True)):
            if i in fp8_layers:
                fp8_lin(f"{att}.{name}", blocks[key]["w"][i], per_channel)
            else:
                lin(f"{att}.{name}", blocks[key], i)
        for name, key in (("q_layernorm", "q_ln"), ("q_layernorm_xattn", "qx_ln"),
                          ("k_layernorm", "k_ln"), ("k_layernorm_xattn", "kx_ln")):
            ln(f"{att}.{name}", blocks[key], i)
        lin(f"{att}.linear_kv_xattn", blocks["kv_xattn"], i)
        lin(f"{pre}.ada_modulate_layer.proj.0", blocks["ada_proj"], i, bias=True)
        ln(f"{pre}.self_attn_post_norm", blocks["self_post_norm"], i)
        ln(f"{pre}.mlp_post_norm", blocks["mlp_post_norm"], i)
        ln(f"{pre}.mlp.layer_norm", blocks["mlp_ln"], i)
        for name, key, per_channel in (("linear_fc1", "fc1", False), ("linear_fc2", "fc2", True)):
            if i in fp8_layers:
                fp8_lin(f"{pre}.mlp.{name}", blocks[key]["w"][i], per_channel)
            else:
                lin(f"{pre}.mlp.{name}", blocks[key], i)
    ln("videodit_blocks.final_layernorm", params["final_layernorm"])
    lin("final_linear.linear", params["final_linear"])
    return sd


def magi_w8a8_phase(dev: torch.device, smi: str, params: dict, ref: dict, inputs) -> dict:
    """Phase 28: phase 27's tree to W8A8 (`magi_quantize_params_int8` on the
    card, layer by layer), the walk over a bf16, an int8 and an e4m3 window
    cache, each against phase 27's velocities; then the fp8 distill layout
    at full width, 3 layers, from a reference-format .pt through
    `convert_magi_state_dict`: its plain e4m3 forward against its
    `magi_distill_quant_to_int8` W8A8 forward. Returns the launches."""
    t0 = time.perf_counter()
    cfg = magi_config("4p5b")
    x0, caps = inputs
    qparams = magi_quantize_params_int8(params)
    print(f"magi-4.5B W8A8: {memory_bytes(qparams['blocks']) / 1e9:.3f} GB of block weights "
          f"(bf16: {memory_bytes(params['blocks']) / 1e9:.3f} GB)", flush=True)
    fp8_src = {k: v for k, v in params.items() if k != "blocks"}
    fp8_src["blocks"] = tree_map(lambda x: x[:MAGI_FP8_LAYERS].clone(), params["blocks"])
    del params["blocks"]
    torch.cuda.empty_cache()
    launches, walks = {}, {}
    for kv in ("bf16", "int8", "e4m3"):
        statics = make_magi_statics(cfg, 1, *MAGI_720, MAGI_WALK["chunk_num"],
                                    quantize_kv=kv == "int8",
                                    kv_dtype=FP8 if kv == "e4m3" else None)
        reset_counts()
        walk = magi_walk(qparams, statics, x0, caps)
        got = since_reset()
        want = walk_launches(cfg, walk, True, kv)
        print(f"magi-4.5B W8A8 walk, {kv} cache: launches {got} (the code implies {want})",
              flush=True)
        gate(got == want, f"MAGI-4.5B W8A8 {kv} walk launches")
        add_counts(launches, got)
        errs = step_errors(walk["vels"], ref["vels"])
        print(f"magi-4.5B W8A8 walk, {kv} cache, against the bf16 walk: velocity rel err "
              f"by step {['%.3e' % e for e in errs]} (tol {MAGI_W8A8_RTOL:g}); latents "
              f"{rel_err(walk['x'], ref['x']):.3e}", flush=True)
        gate(max(errs) <= MAGI_W8A8_RTOL and all(torch.isfinite(v).all() for v in walk["vels"]),
             f"W8A8 {kv} walk against bf16")
        if kv != "bf16":
            kv_errs = step_errors(walk["vels"], walks["bf16"]["vels"])
            print(f"magi-4.5B W8A8 walk, {kv} cache, against the W8A8 bf16-cache walk: "
                  f"{['%.3e' % e for e in kv_errs]} (tol {MAGI_KV_RTOL:g})", flush=True)
            gate(max(kv_errs) <= MAGI_KV_RTOL, f"{kv} cache against bf16 cache")
        for n, s in walk["secs"]:
            print(f"magi-4.5B W8A8 {kv} cache window forward of {n} chunks: {s:.3f} s",
                  flush=True)
        del walk["cache"]
        walks[kv] = walk
        torch.cuda.empty_cache()
    del qparams, walks
    torch.cuda.empty_cache()

    # the fp8 distill layout: first and last layers bf16, the middle e4m3
    cfg3 = dataclasses.replace(cfg, num_layers=MAGI_FP8_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_magi_") as tmp:
        path = os.path.join(tmp, "magi_fp8.pt")
        t1 = time.perf_counter()
        sd = magi_reference_sd(fp8_src, cfg3, fp8_layers=(1,))
        torch.save(sd, path)
        nbytes = os.path.getsize(path)
        del sd
        w_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        tree = convert_magi_state_dict(load_torch_state_dict(path), cfg3, torch.bfloat16, dev)
        r_s = time.perf_counter() - t1
    gate("blocks_mid" in tree and tree["blocks_mid"]["q"]["w_q"].dtype == FP8
         and torch.equal(tree["blocks_first"]["fc1"]["w"], fp8_src["blocks"]["fc1"]["w"][0])
         and torch.equal(tree["blocks_last"]["q"]["w"], fp8_src["blocks"]["q"]["w"][2])
         and torch.equal(tree["x_embedder"]["w"], fp8_src["x_embedder"]["w"]),
         "fp8 layout converted, plain leaves bit-equal to the drawn tree")
    print(f"magi-4.5B fp8 distill layout, {MAGI_FP8_LAYERS} layers: .pt write "
          f"{gb_per_s(nbytes, w_s)}, read + convert {gb_per_s(nbytes, r_s)}", flush=True)
    del fp8_src
    s3 = make_magi_statics(cfg3, 1, *MAGI_720, 2)
    cw = s3.geo.chunk_width
    cap, mask, _, _ = caps
    args = (x0[:, :2 * cw], torch.tensor([[0.3, 0.7]], device=dev), cap[:, None].expand(
        1, 2, -1, -1), mask[:, None].expand(1, 2, -1), )
    outs = {}
    for name, tr in (("e4m3", tree), ("int8", None)):
        if tr is None:
            tr = magi_distill_quant_to_int8(tree)
            gate(tr["blocks_mid"]["q"]["w_q"].dtype == torch.int8, "requantized to int8")
            del tree
        reset_counts()
        v, _ = magi_forward_window_scan(tr, s3, None, *args, init_kv_cache(s3.spec, dev), 0,
                                        [[0, 1], [0, 2]], distill_dt_factor=MAGI_DISTILL_DT)
        got = since_reset()
        outs[name] = v.float()
        print(f"magi-4.5B fp8 distill layout, {name} forward of 2 chunks: launches {got}",
              flush=True)
        add_counts(launches, got)
        del tr
    err = rel_err(outs["int8"], outs["e4m3"])
    print(f"magi-4.5B fp8 distill: W8A8 requant against the plain e4m3 forward, "
          f"distill_dt_factor {MAGI_DISTILL_DT:g}: rel err {err:.3e} (tol {MAGI_FP8_RTOL:g})",
          flush=True)
    gate(err <= MAGI_FP8_RTOL and torch.isfinite(outs["int8"]).all().item(), "fp8 requant")
    torch.cuda.empty_cache()
    phase("magi-4.5B w8a8", t0)
    return launches


def magi_24b_phase(dev: torch.device, smi: str) -> dict:
    """Phase 29: MAGI-24B widths, MAGI_24B_LAYERS of 48 layers, W8A8 with the
    int8 window cache at 720x1280: one window forward of 2 chunks with fc1
    concatenated and split (bit-equal); then the 3-CFG paths at these widths,
    the B=2 window forward (per-chunk dispatch, then the row sync) and the
    uncond forward of MAGI_WALK's 4 denoising chunks as 4 rows. Seconds and
    each path's transient device bytes (its peak less what was resident
    before it), and the full depth's bytes worked out from them. Returns the
    launches."""
    t0 = time.perf_counter()
    full = magi_config("24b")
    cfg = dataclasses.replace(full, num_layers=MAGI_24B_LAYERS)
    g = torch.Generator(device=dev).manual_seed(29)
    params = magi_quantize_params_int8(init_magi_params(cfg, g, dev))
    torch.cuda.empty_cache()
    st = make_magi_statics(cfg, 1, *MAGI_720x1280, 2, quantize_kv=True)
    cw, ct = st.geo.chunk_width, st.geo.chunk_tokens
    caps = magi_captions(params, cfg, dev, g)
    x = torch.randn(1, 2 * cw, *MAGI_720x1280, cfg.latent_channels, generator=g,
                    device=dev).to(torch.bfloat16)
    cap, mask, null, null_mask = caps
    args = (x, torch.tensor([[0.3, 0.7]], device=dev), cap[:, None].expand(1, 2, -1, -1),
            mask[:, None].expand(1, 2, -1))
    kvr = [[0, 1], [0, 2]]
    outs, launches, act = {}, {}, {}

    def measured(label, fn):
        """fn() timed, with its launches and its transient device bytes."""
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        got = since_reset()
        add_counts(launches, got)
        act[label] = torch.cuda.max_memory_allocated(dev) - base
        print(f"magi-24B widths ({MAGI_24B_LAYERS} of {full.num_layers} layers), W8A8 + int8 "
              f"cache, {label}: {secs:.3f} s, transient {act[label] / 1e9:.3f} GB, "
              f"launches {got}", flush=True)
        return out

    for layout, tree in (("concatenated", params),
                         ("split", split_gated_fc1(params, cfg.ffn_hidden_size))):
        cache = init_kv_cache(st.spec, dev)
        outs[layout] = measured(
            f"fc1 {layout}: window forward of 2 chunks ({ct} tokens each)",
            lambda: magi_forward_window_scan(tree, st, None, *args, cache, 0, kvr))
        del cache
    (va, ca), (vb, cb) = outs["concatenated"], outs["split"]
    gate(torch.equal(va, vb) and all(torch.equal(a, b) for a, b in zip(ca, cb) if a is not None)
         and torch.isfinite(va).all().item(), "24B fc1 layouts bit-equal, finite")
    del outs, va, vb, ca, cb
    torch.cuda.empty_cache()

    # the 3-CFG batch: row 0 with the caption, row 1 the null caption, the
    # window span synced from row 1 after the per-chunk walk, as the pipeline
    # dispatches it
    st2 = make_magi_statics(cfg, 2, *MAGI_720x1280, 2, quantize_kv=True)
    cache2 = init_kv_cache(st2.spec, dev)
    x2, t2 = x.expand(2, -1, -1, -1, -1).contiguous(), args[1].expand(2, -1)
    caps2 = torch.stack([cap[0].expand(2, -1, -1), null[0].expand(2, -1, -1)])
    masks2 = torch.stack([mask[0].expand(2, -1), null_mask[0].expand(2, -1)])

    def cfg_window():
        v, c = magi_forward_window_scan(params, st2, None, x2, t2, caps2, masks2, cache2, 0, kvr,
                                        caption_dropout=torch.tensor([False, True], device=dev))
        return v, sync_cache_rows(st2.spec, c, 0, 2 * ct)

    v2, cache2 = measured("3-CFG B=2 window forward of 2 chunks", cfg_window)
    gate(all(torch.equal(f[:, 0, :2 * ct], f[:, 1, :2 * ct]) for f in cache2 if f is not None)
         and torch.isfinite(v2).all().item(), "24B 3-CFG batch: rows synced, finite")
    del v2, cache2
    torch.cuda.empty_cache()
    n = MAGI_WALK["chunk_num"]
    xu = torch.randn(n, cw, *MAGI_720x1280, cfg.latent_channels, generator=g,
                     device=dev).to(torch.bfloat16)
    tu = torch.linspace(0.1, 0.7, n, device=dev)[:, None]
    vu = measured(f"uncond forward of {n} chunk rows", lambda: magi_forward_uncond(
        params, st2, xu, tu, null.expand(n, -1, -1)[:, None], null_mask.expand(n, -1)[:, None]))
    gate(vu.shape == xu.shape and torch.isfinite(vu).all().item(), "24B uncond forward")
    del vu, xu

    w_blocks = memory_bytes(params["blocks"])
    w_rest = memory_bytes(params) - w_blocks
    w_full = w_blocks // MAGI_24B_LAYERS * full.num_layers
    full_cache = kv_cache_bytes(dataclasses.replace(st.spec, num_layers=full.num_layers,
                                                    batch=2, max_tokens=4 * ct))
    card = torch.cuda.get_device_properties(dev).total_memory
    resident = w_full + w_rest + full_cache
    print(f"magi-24B widths at {MAGI_24B_LAYERS} layers: block weights {w_blocks / 1e9:.3f} GB, "
          f"other weights {w_rest / 1e9:.3f} GB; at the full {full.num_layers} layers, worked "
          f"out: {w_full / 1e9:.3f} GB of int8 block weights + {w_rest / 1e9:.3f} GB + a 3-CFG "
          f"(B=2) int8 cache of 4 chunks {full_cache / 1e9:.3f} GB = {resident / 1e9:.3f} GB "
          f"resident, of {card / 1e9:.1f} GB", flush=True)
    for label, b in act.items():
        print(f"magi-24B full depth with the transient of the {label}: "
              f"{(resident + b) / 1e9:.3f} GB, fits {resident + b <= card}", flush=True)
    del params
    torch.cuda.empty_cache()
    phase("magi-24B", t0)
    return launches, resident


def magi_phases(dev: torch.device, smi: str) -> dict:
    """Phases 26-34, 30-32 between 27 and 28 (they take phase 27's bf16
    tree, which phase 28 quantizes); returns the launches of the MAGI main
    paths (27-34)."""
    t0 = time.perf_counter()
    worst = magi_kernel_phase(dev)
    print(f"magi kernels: worst max_abs by kernel {worst}", flush=True)
    phase("magi kernels", t0)
    params, walk, inputs, launches = magi_4p5b_phase(dev, smi)
    vae = vitvae_phase(dev, smi)
    pipe, cap, mask = magi_pipeline_phase(dev, smi, params, vae)
    add_counts(launches, pipe)
    add_counts(launches, magi_distill_phase(dev, smi, params, cap, mask))
    add_counts(launches, magi_w8a8_phase(dev, smi, params, walk, inputs))
    del params, walk
    torch.cuda.empty_cache()
    l24, resident = magi_24b_phase(dev, smi)
    add_counts(launches, l24)
    add_counts(launches, magi_24b_pipeline_phase(dev, smi, vae, cap, mask, resident))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_magi_cli_") as tmp:
        add_counts(launches, magi_cli_phase(dev, smi, vae, tmp))
    del vae
    torch.cuda.empty_cache()
    print(f"launches on the MAGI paths (phases 27-34): {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phases 30-34: MAGI-1's ViT-VAE, pipelines, text tower and magi command
# ---------------------------------------------------------------------------

VIT_ROWS = 1024          # query rows a slice of the ViT-VAE attention gate
# One ViT-VAE block in bf16 against the same block in float32 on the same
# input, its update (output less input): bf16 roundings of q/k/v, the
# probabilities, the attention output and the MLP, ~2^-9 relative each,
# through ~10 roundings (LAYER_RTOL's reasoning), plus the rounding of the
# block's output x + update to bf16, which the update's norm does not scale
# (the decoder's tokens are ~10x its update). That rounding is at most half
# an ulp of each element (2^-9 to 2^-8 relative by where the mantissa lies);
# in norm, uniform within the half ulp over log-uniform mantissas, it comes
# to ~1.7e-3 ||y||, under VIT_OUT_ROUND = 2^-9 ||y||:
#     ||u_bf16 - u_f32|| <= VIT_BLOCK_RTOL ||u_f32|| + VIT_OUT_ROUND ||y_f32||
VIT_BLOCK_RTOL = LAYER_RTOL
VIT_OUT_ROUND = 2.0 ** -9
MAGI_PIPE_STEPS = 4      # magi_4p5b.json takes 64 (a cut for the wall, as phase 27)
# The distill-quant config's 64 steps cut to 8: 4 steps' t values (0,
# 0.0217, 0.1, 0.3, 1) never pass the nearly-clean threshold 0.3.
MAGI_DISTILL_STEPS = 8
MAGI_T5_LAYERS = 2       # of 24: t5-v1_1-xxl width, depth cut (phase 16 ran the tower's depth)
MAGI_RESUME_AFTER = 3    # windows of the walk before the resume's break
MAGI_CLI_LAYERS = 2      # the magi command's .pt: MAGI-4.5B widths at 2 of 34 layers
MAGI_PROMPT = "a red fox runs through snow at dawn"
MAGI_FP8_LINEARS = ("q", "qx", "k", "v", "proj", "fc1", "fc2")  # the distill layout's e4m3 linears
MAGI_FP8_PER_CHANNEL = ("proj", "fc2")                           # with smooth_scale


@contextlib.contextmanager
def capture_first(module, name: str, store: dict):
    """module.name wrapped: its first call's (args, kwargs) kept in store[name]."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        store.setdefault(name, (args, kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(module, name, spy):
        yield


def peak_since(dev, base: int) -> int:
    return torch.cuda.max_memory_allocated(dev) - base


def vitvae_phase(dev: torch.device, smi: str):
    """Phase 30: the MAGI ViT-VAE at full width (ViTVAEConfig(): 768 wide, 12
    blocks, 16 heads of 48, patch 4x8x8, z 16), seeded float32 weights, bf16
    compute: decode a 6-latent-frame chunk at 90x90 (48601 tokens) to
    [1, 24, 720, 720, 3]; the decoder's first attention call against the
    plain float32 version on two slices of query rows; its first block in
    bf16 against float32; the pos-embed resize and the rope tables against
    the CPU path; encode a 1-frame image and a 24-frame prefix at 720x720;
    decode a 24B chunk at 90x160 (86401 tokens). Seconds and peak device
    bytes of each. Returns the VAE."""
    t0 = time.perf_counter()
    cfg = ViTVAEConfig()
    g = torch.Generator(device=dev).manual_seed(30)
    vae = ViTVAE(cfg, params=init_vitvae_params(cfg, g, dev), device=dev)
    print(f"vitvae: embed {cfg.embed_dim}, depth {cfg.depth}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, patch {cfg.patch_length}x{cfg.patch_size}x{cfg.patch_size}, z "
          f"{cfg.z_chans}; {memory_bytes(vae.params) / 1e9:.3f} GB of float32 weights; "
          f"attention: SDPA pinned to the flash backend", flush=True)
    hw = tuple(cfg.patch_size * n for n in MAGI_720)        # 720 x 720 pixels
    frames = 6 * cfg.patch_length                            # a chunk's 24 pixel frames
    z = torch.randn(1, 6, *MAGI_720, cfg.z_chans, generator=g, device=dev).to(torch.bfloat16)
    seen = {}
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with capture_first(vitvae_mod, "vit_attention", seen), \
            capture_first(vitvae_mod, "_vit_block", seen):
        px, first_s = timed(lambda: vae.decode(z))
    peak = peak_since(dev, base)
    gate(tuple(px.shape) == (1, frames, *hw, 3) and px.dtype == torch.bfloat16
         and torch.isfinite(px).all().item() and px.abs().max().item() <= 1.0,
         "vitvae decode shape / finite / range")
    px, dec_s = timed(lambda: vae.decode(z))
    print(f"vitvae decode {list(z.shape)} -> {list(px.shape)}: {dec_s:.3f} s a chunk "
          f"(first call {first_s:.3f} s), peak {peak / 1e9:.3f} GB above the resident "
          f"{base / 1e9:.3f}; {smi}", flush=True)
    del px

    # the decoder's first attention call: SDPA (flash) against the plain
    # float32 version, rows at both ends of the 48601 tokens
    (q, k, v), _ = seen.pop("vit_attention")
    s = q.shape[1]
    gate(s == 6 * MAGI_720[0] * MAGI_720[1] + 1 and q.dtype == torch.bfloat16,
         "vitvae attention operands")
    out = vitvae_mod.vit_attention(q, k, v)
    for r0 in (0, s - VIT_ROWS):
        ref = vitvae_mod.vit_attention_reference(q[:, r0:r0 + VIT_ROWS].float(), k.float(),
                                                 v.float())
        ok, _ = check_out_case(f"vitvae attention (SDPA flash) rows [{r0}, {r0 + VIT_ROWS}) "
                               f"of {s} against the plain float32 version",
                               out[:, r0:r0 + VIT_ROWS], ref)
        gate(ok, "vitvae attention against its plain version")
        del ref
    nh, hd = q.shape[2], q.shape[3]
    ms = time_ms(lambda: vitvae_mod.vit_attention(q, k, v), iters=5, warmup=1)
    flops = 4.0 * s * s * nh * hd
    bnd, by = bound_of(flops / PEAK_BF16_FLOPS * 1e3, 4 * q.numel() * 2 / PEAK_BYTES_PER_S * 1e3)
    print(f"vitvae attention {s} x {s}, {nh} heads of {hd}: {ms:.3f} ms a block, bound "
          f"{bnd:.3f} ms ({by}), {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    expect_raise("vit_attention on a head dim the flash backend does not take (512)",
                 RuntimeError, lambda: vitvae_mod.vit_attention(
                     *(torch.zeros(1, 8, 1, 512, dtype=torch.bfloat16, device=dev),) * 3))
    del q, k, v, out

    # the first block in bf16 against float32 on the same input; the rope
    # tables it got and the pos-embed resize against the CPU path
    (p, x, _, sin, cos), _ = seen.pop("_vit_block")
    y16 = vitvae_mod._vit_block(p, x, cfg, sin, cos)
    y32 = vitvae_mod._vit_block(p, x.float(), cfg, sin, cos)
    u32 = y32 - x.float()
    diff = (y16.float() - x.float() - u32).norm().item()
    bound = VIT_BLOCK_RTOL * u32.norm().item() + VIT_OUT_ROUND * y32.norm().item()
    print(f"vitvae block 0 in bf16 against float32, its update: rel err "
          f"{diff / u32.norm().item():.3e}, |diff| {diff:.4g} against the bound {bound:.4g} "
          f"(VIT_BLOCK_RTOL {VIT_BLOCK_RTOL:g} |u| + 2^-9 |y|; |u| / |y| "
          f"{u32.norm().item() / y32.norm().item():.3f})", flush=True)
    gate(diff <= bound, "vitvae block bf16 against float32")
    del y16, y32, x
    grid = (6, *MAGI_720)
    sin_np, cos_np = vitvae_rope_tables(grid, cfg.head_dim, cfg.rope_ref_feat_shape)
    pos = vae.params["decoder"]["pos_embed"]
    card = vitvae_mod._pos_embed_for(cfg, pos, grid).cpu()
    host = vitvae_mod._pos_embed_for(cfg, pos.cpu(), grid)
    diff = (card - host).abs().max().item()
    print(f"vitvae rope tables equal to the host's {np.array_equal(sin.cpu().numpy(), sin_np) and np.array_equal(cos.cpu().numpy(), cos_np)}; "
          f"pos-embed resize {(cfg.latent_length, cfg.latent_size, cfg.latent_size)} -> {grid} "
          f"on the card against the CPU: "
          f"max |diff| {diff:.3e}", flush=True)
    gate(np.array_equal(sin.cpu().numpy(), sin_np) and np.array_equal(cos.cpu().numpy(), cos_np)
         and diff <= 1e-6, "vitvae rope tables / pos-embed resize against the CPU path")
    del sin, cos, p

    # encode: a 1-frame image and a 24-frame prefix at 720x720
    img = (torch.rand(1, 1, *hw, 3, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    vid = (torch.rand(1, frames, *hw, 3, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    for name, video, want in (("1-frame image", img, (1, 1, *MAGI_720, cfg.z_chans)),
                              (f"{frames}-frame prefix", vid, (1, 6, *MAGI_720, cfg.z_chans))):
        vae.encode(video)
        torch.cuda.reset_peak_memory_stats(dev)
        lat, secs = timed(lambda: vae.encode(video))
        gate(tuple(lat.shape) == want and torch.isfinite(lat).all().item(),
             f"vitvae encode {name}")
        print(f"vitvae encode {name} {list(video.shape)} -> {list(lat.shape)}: {secs:.3f} s, "
              f"peak {peak_since(dev, base) / 1e9:.3f} GB above the resident", flush=True)
    del img, vid, lat

    # a MAGI-24B chunk at 720x1280: 86401 tokens
    z = torch.randn(1, 6, *MAGI_720x1280, cfg.z_chans, generator=g, device=dev).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    px, first_s = timed(lambda: vae.decode(z))
    peak = peak_since(dev, base)
    gate(tuple(px.shape) == (1, frames, *(cfg.patch_size * n for n in MAGI_720x1280), 3)
         and torch.isfinite(px).all().item(), "vitvae 24B decode")
    _, dec24_s = timed(lambda: vae.decode(z))
    print(f"vitvae decode {list(z.shape)} -> {list(px.shape)}: {dec24_s:.3f} s a chunk "
          f"(first call {first_s:.3f} s), peak {peak / 1e9:.3f} GB above the resident", flush=True)
    del px, z
    torch.cuda.empty_cache()
    phase("vitvae", t0)
    return vae


class TimedDecode:
    """A ViT-VAE whose decode is timed (the device synced around it) and
    whose latents are kept, for the pipeline phases' gates."""

    def __init__(self, vae):
        self.vae, self.cfg, self.secs, self.latents = vae, vae.cfg, [], []

    def decode(self, z):
        self.latents.append(z.clone())
        px, secs = timed(lambda: self.vae.decode(z))
        self.secs.append(secs)
        return px


def magi_t5_caption(dev: torch.device, g, cfg: MagiModelConfig):
    """MagiT5Embedder at t5-v1_1-xxl width, MAGI_T5_LAYERS layers, bf16,
    the byte stand-in tokenizer: its features bit-equal to umt5_encode on
    the same ids, then padded to caption_max_length, as the CLI does.
    Returns (caption [1, 800, 4096] float32, its prefix mask int32)."""
    t5 = dataclasses.replace(t5_v1_1_xxl_config(), num_layers=MAGI_T5_LAYERS)
    emb = MagiT5Embedder(t5, tokenizer=ByteTokenizer(), device=dev, generator=g)
    (feats, mask), secs = timed(lambda: emb.get_text_embeddings([MAGI_PROMPT]))
    ids = ByteTokenizer()([text_preprocessing(MAGI_PROMPT)], max_length=120)["input_ids"]
    ref = umt5_encode(emb.params, t5, torch.as_tensor(ids, device=dev), mask).to(torch.bfloat16)
    n = int(mask.sum())
    print(f"magi t5 (t5-v1_1-xxl width, {MAGI_T5_LAYERS} of 24 layers, bf16): features "
          f"{list(feats.shape)} {feats.dtype}, {n} tokens, bit-equal to umt5_encode "
          f"{torch.equal(feats, ref)}; {secs:.3f} s", flush=True)
    gate(torch.equal(feats, ref) and tuple(feats.shape) == (1, 120, t5.dim)
         and mask.dtype == torch.int32, "MagiT5Embedder against umt5_encode")
    del emb, ref
    pad = cfg.caption_max_length - feats.shape[1]
    return F.pad(feats.float(), (0, 0, 0, pad)), F.pad(mask, (0, pad))


def walk_forwards(sched_cfg: MagiScheduleConfig, rt, max_tokens: int, ct: int,
                  prefix: int = 0) -> tuple:
    """(chunk forwards, uncond calls, nearly-clean re-mixes) the pipeline's
    code implies for a walk: each window's chunks, the clean one included,
    one forward each under per-chunk dispatch; the 3-CFG uncond forward a
    denoising chunk (one call when the window has one); the distilled
    re-mix's extra chunk when the oldest denoising chunk's t passes the
    threshold and its slot fits; each prefix chunk's extraction forward."""
    sched = ChunkSchedule(sched_cfg)
    fwd, unc, remix = prefix, 0, 0
    for step in range(sched.total_forward_steps):
        c0, c1, _, _ = sched.window(step)
        extra = sched.fwd_extra_1st_chunk(step)
        w0 = c0 - extra
        n = c1 - w0
        if rt.cfg_number == 1 and rt.distill:
            t_first = float(sched.timesteps(step)[0])
            if t_first > rt.distill_nearly_clean_chunk_threshold and \
                    (w0 + n + 1) * ct <= max_tokens:
                remix += 1
        if rt.cfg_number == 3:
            unc += c1 - c0
        fwd += n
    return fwd + remix, unc, remix


def cfg3_hand_walk(params, statics, noise, cap, mask, rt, chunk_num: int) -> list:
    """The pipeline's 3-CFG walk restated through the model's calls (phase
    27's walk at B=2 plus the 3-CFG combination): each window one
    `magi_forward` a chunk, row 0 with the caption, row 1 the null caption
    with the adaln dropout token, the window's span synced from row 1 once
    after it; a prefix-free `magi_forward_uncond` a denoising chunk; the
    per-chunk combination (1 - s_p) v_unc + (s_p - s_t) v_pre + s_t v_text
    in float32, the scales searchsorted from cfg_t_range; Euler steps.
    Returns the clean chunks in order."""
    geo, dev = statics.geo, noise.device
    cw, ct = geo.chunk_width, geo.chunk_tokens
    sched = ChunkSchedule(MagiScheduleConfig(
        chunk_num=chunk_num, chunk_width=cw, window_size=rt.window_size,
        num_steps=rt.num_steps, t_schedule=rt.t_schedule, t_shift=rt.t_shift,
        noise2clean_kvrange=rt.noise2clean_kvrange,
        clean_chunk_kvrange=rt.clean_chunk_kvrange, clean_t=rt.clean_t))
    cache = init_kv_cache(statics.spec, dev)
    table = params["y_embedder"]["null_caption_embedding"]
    null = table[None, :cap.shape[1]].float()
    null_mask = torch.zeros(1, cap.shape[1], device=dev)
    null_mask[:, :50] = 1.0
    drop = torch.tensor([False, True], device=dev)
    x = noise.expand(2, *noise.shape[1:]).clone()
    edges = np.asarray(rt.cfg_t_range, np.float64) - 1e-7
    clean_chunks = []
    for step in range(sched.total_forward_steps):
        c0, c1, _, _ = sched.window(step)
        extra = sched.fwd_extra_1st_chunk(step)
        w0 = c0 - extra
        n = c1 - w0
        t_vals = sched.timesteps(step)
        if extra:
            t_vals = np.concatenate([[rt.clean_t], t_vals])
        kvr = sched.kv_ranges(step, include_clean=extra)
        t = torch.as_tensor(np.asarray(t_vals, np.float32), device=dev)[None].expand(2, n)
        clean = [extra] + [False] * (n - 1)
        caps = torch.cat([torch.stack([null[0] if c else cap[0].float() for c in clean])[None],
                          null[:, None].expand(1, n, *null.shape[1:])]).to(torch.bfloat16)
        masks = torch.cat([torch.stack([null_mask[0] if c else mask[0].float()
                                        for c in clean])[None],
                           null_mask[:, None].expand(1, n, null.shape[1])])
        vels = []
        for i in range(n):
            v, cache = magi_forward(params, statics, None, x[:, (w0 + i) * cw:(w0 + i + 1) * cw],
                                    t[:, i:i + 1], caps[:, i:i + 1], masks[:, i:i + 1], cache,
                                    w0 + i, kvr[i:i + 1], caption_dropout=drop)
            vels.append(v)
        vel = torch.cat(vels, dim=1)
        sync_cache_rows(statics.spec, cache, w0 * ct, n * ct)
        n_den = c1 - c0
        t_den = np.asarray(t_vals)[extra:]
        idx = np.searchsorted(edges, t_den) - 1
        s_p = torch.as_tensor(np.asarray(rt.prev_chunk_scales, np.float32)[idx], device=dev)
        s_t = torch.as_tensor(np.asarray(rt.text_scales, np.float32)[idx], device=dev)
        x_den = x[0, c0 * cw:c1 * cw].reshape(n_den, cw, *x.shape[2:])
        t_u = torch.as_tensor(np.asarray(t_den, np.float32), device=dev).reshape(n_den, 1)
        v_t = vel[0, extra * cw:].reshape(n_den, cw, *vel.shape[2:])
        v_p = vel[1, extra * cw:].reshape(n_den, cw, *vel.shape[2:])
        comb = []
        for i in range(n_den):
            v_u = magi_forward_uncond(params, statics, x_den[i:i + 1], t_u[i:i + 1],
                                      null[:, None].to(torch.bfloat16), null_mask[:, None])
            w_u = (1.0 - s_p[i:i + 1]).reshape(-1, 1, 1, 1, 1)
            w_p = (s_p[i:i + 1] - s_t[i:i + 1]).reshape(-1, 1, 1, 1, 1)
            w_t = s_t[i:i + 1].reshape(-1, 1, 1, 1, 1)
            comb.append(w_u * v_u.float() + w_p * v_p[i:i + 1].float()
                        + w_t * v_t[i:i + 1].float())
        v = torch.cat(comb).reshape(1, n_den, cw, *vel.shape[2:])
        d = torch.as_tensor(sched.integrate_deltas(step), dtype=v.dtype,
                            device=dev).reshape(1, -1, 1, 1, 1, 1)
        x_d = x[:, c0 * cw:c1 * cw].reshape(2, n_den, cw, *x.shape[2:])
        x[:, c0 * cw:c1 * cw] = (x_d + v * d).reshape(2, n_den * cw, *x.shape[2:]).to(x.dtype)
        done = sched.mark_integrated(step)
        if done is not None:
            clean_chunks.append(x[:1, done * cw:(done + 1) * cw].clone())
    return clean_chunks


def row_sync_checker(sched_cfg: MagiScheduleConfig, ct: int, results: list, keep: dict,
                     keep_after: int = None):
    """A state_callback: after each window, whether every cache field's row
    0 equals row 1 over the window's span; after window keep_after, the
    state cloned into keep."""
    sched = ChunkSchedule(sched_cfg)

    def on_state(state, step):
        c0, c1, _, _ = sched.window(step)
        span = slice((c0 - sched.fwd_extra_1st_chunk(step)) * ct, c1 * ct)
        results.append(all(torch.equal(f[:, 0, span], f[:, 1, span])
                           for f in state["cache"].values()))
        if keep_after is not None and step == keep_after - 1:
            keep.update(x=state["x"].clone(), step=state["step"],
                        cache={k: f.clone() for k, f in state["cache"].items()},
                        chunk_denoise_count=state["chunk_denoise_count"].copy())

    return on_state


def magi_pipeline_phase(dev: torch.device, smi: str, params: dict, vae) -> tuple:
    """Phase 31: MagiVideoPipeline on magi_4p5b.json at full width and depth
    (phase 27's bf16 tree), 3-CFG (B=2 + the uncond forward), 720x720, 4
    chunks, MAGI_PIPE_STEPS steps, per-chunk dispatch, the caption from
    MagiT5Embedder, each chunk decoded by phase 30's VAE: launches against
    the code's count, the rows' spans synced after each window, the chunks
    bit-equal to a hand walk; "scan" bit-equal to "per_chunk" on one window;
    an I2V run from a seeded 720x720 image; a resume after window
    MAGI_RESUME_AFTER bit-equal. Returns (launches, caption, mask)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(31)
    mcfg, rt = magi_config_from_json(os.path.join(REPO, "examples", "configs",
                                                  "magi_4p5b.json"))
    rt.num_steps = MAGI_PIPE_STEPS
    cap, mask = magi_t5_caption(dev, g, mcfg)
    chunk_num = MAGI_WALK["chunk_num"]
    prof = InferixProfiler(ProfilingConfig(enabled=True))
    tvae = TimedDecode(vae)
    pipe = MagiVideoPipeline(mcfg, rt, params=params, latent_h=MAGI_720[0],
                             latent_w=MAGI_720[1], max_chunks=chunk_num, profiler=prof,
                             device=dev, vae=tvae)
    ct, cw = pipe.statics.geo.chunk_tokens, pipe.statics.geo.chunk_width
    hw = tuple(vae.cfg.patch_size * n for n in MAGI_720)    # 720 x 720 pixels
    fpc = cw * vae.cfg.patch_length                         # pixel frames a chunk
    sched_cfg = MagiScheduleConfig(chunk_num=chunk_num, chunk_width=cw,
                                   window_size=rt.window_size, num_steps=rt.num_steps,
                                   noise2clean_kvrange=rt.noise2clean_kvrange,
                                   clean_chunk_kvrange=rt.clean_chunk_kvrange)
    synced, keep, first = [], {}, []
    pipe.generate_chunks = functools.partial(
        pipe.generate_chunks, state_callback=row_sync_checker(sched_cfg, ct, synced, keep,
                                                              MAGI_RESUME_AFTER))
    launches = {}
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    def on_chunk(px, idx):
        gate(torch.isfinite(px).all().item() and tuple(px.shape) == (1, fpc, *hw, 3),
             f"pipeline chunk {idx} pixels")
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t1)

    video = pipe.generate_video(cap, mask, chunk_num,
                                generator=torch.Generator(device=dev).manual_seed(rt.seed),
                                chunk_callback=on_chunk)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    del pipe.generate_chunks   # the later runs without the checker (and no reference cycle)
    got = since_reset()
    add_counts(launches, got)
    fwd, unc, _ = walk_forwards(sched_cfg, rt, pipe.statics.spec.max_tokens, ct)
    want = {"flash_attention_prefix": 2 * mcfg.num_layers * (fwd + unc)}
    print(f"magi-4.5B MagiVideoPipeline (3-CFG, {chunk_num} chunks, {rt.num_steps} steps): "
          f"launches {got} (the code implies {want}: {fwd} chunk forwards at B=2 and {unc} "
          f"uncond forwards, {2 * mcfg.num_layers} B1 each); {total_s:.3f} s in all, the first "
          f"chunk's pixels after {first[0]:.3f} s; {smi}", flush=True)
    gate(got == want, "MAGI-4.5B pipeline launches")
    gate(tuple(video.shape) == (1, fpc * chunk_num, *hw, 3), "pipeline video shape")
    gate(len(synced) == len(prof.diffusion_steps) and all(synced),
         "the rows' spans synced after each window")
    sched = ChunkSchedule(sched_cfg)
    for rec in prof.diffusion_steps:
        c0, c1, _, _ = sched.window(rec["step"])
        n = c1 - c0 + sched.fwd_extra_1st_chunk(rec["step"])
        print(f"magi-4.5B pipeline window {rec['step']}: {n} chunks at B=2 + {c1 - c0} uncond "
              f"rows: {rec['time_ms'] / 1e3:.3f} s", flush=True)
    print(f"magi-4.5B pipeline decode a chunk (phase 30's VAE, bf16): "
          f"{['%.3f' % s for s in tvae.secs]} s; chunks (the profiler) "
          f"{['%.3f' % (b['time_ms'] / 1e3) for b in prof.blocks]} s", flush=True)
    latents = tvae.latents
    del video
    torch.cuda.empty_cache()

    # the hand walk from the same draw
    noise = torch.randn(1, chunk_num * cw, *MAGI_720, mcfg.latent_channels,
                        generator=torch.Generator(device=dev).manual_seed(rt.seed),
                        device=dev).to(torch.bfloat16)
    hand, hand_s = timed(lambda: cfg3_hand_walk(params, pipe.statics, noise, cap, mask, rt,
                                                chunk_num))
    equal = len(hand) == len(latents) and all(torch.equal(a, b) for a, b in zip(hand, latents))
    print(f"magi-4.5B pipeline chunks bit-equal to the hand walk ({hand_s:.3f} s): {equal}; "
          f"max |diff| by chunk {['%.3e' % (a.float() - b.float()).abs().max().item() for a, b in zip(hand, latents)]}",
          flush=True)
    gate(equal, "pipeline chunks against the hand walk")
    del hand, noise
    torch.cuda.empty_cache()

    # resume from the state kept after window MAGI_RESUME_AFTER
    gate(keep.get("step") == MAGI_RESUME_AFTER, "resume state kept")
    rest, res_s = timed(lambda: list(pipe.generate_chunks(cap, mask, chunk_num,
                                                          resume_state=keep)))
    equal = [i for i, _ in rest] == list(range(chunk_num)) and all(
        torch.equal(c, latents[i]) for i, c in rest)
    print(f"magi-4.5B pipeline resumed after window {MAGI_RESUME_AFTER} ({res_s:.3f} s): "
          f"chunks {[i for i, _ in rest]} bit-equal to the walk without the break: {equal}",
          flush=True)
    gate(equal, "resumed walk bit-equal")
    del rest, keep, latents
    torch.cuda.empty_cache()

    # "scan" against "per_chunk" on one window of 2 chunks, fresh caches
    outs = {}
    xw = torch.randn(1, 2 * cw, *MAGI_720, mcfg.latent_channels, generator=g,
                     device=dev).to(torch.bfloat16).expand(2, -1, -1, -1, -1)
    for disp in ("per_chunk", "scan"):
        p2 = MagiPipeline(mcfg, dataclasses.replace(rt, window_dispatch=disp), params=params,
                          latent_h=MAGI_720[0], latent_w=MAGI_720[1], max_chunks=2, device=dev)
        reset_counts()
        outs[disp] = p2._forward_window(xw, np.array([0.3, 0.1]), cap.to(dev), mask.to(dev),
                                        init_kv_cache(p2.statics.spec, dev), 0, [[0, 1], [0, 2]])
        add_counts(launches, since_reset())
        del p2
    (va, ca), (vb, cb) = outs["per_chunk"], outs["scan"]
    equal = torch.equal(va, vb) and all(torch.equal(a, b) for a, b in zip(ca, cb)
                                        if a is not None)
    print(f"magi-4.5B window of 2 chunks: \"scan\" bit-equal to \"per_chunk\" (velocity and "
          f"cache): {equal}", flush=True)
    gate(equal, "scan against per_chunk")
    del outs, va, vb, ca, cb, xw
    torch.cuda.empty_cache()

    # I2V: one prefix chunk from a seeded 720x720 image, one chunk generated
    img = np.random.default_rng(31).integers(0, 256, (*hw, 3)).astype(np.uint8)
    prefix, enc_s = timed(lambda: encode_prefix_latents(
        vae, process_image(img, *hw), chunk_width=cw).to(torch.bfloat16))
    gate(tuple(prefix.shape) == (1, cw, *MAGI_720, mcfg.latent_channels), "I2V prefix latents")
    tvae.secs.clear()
    reset_counts()
    px, i2v_s = timed(lambda: pipe.generate_video(cap, mask, 2, prefix_latents=prefix))
    got = since_reset()
    add_counts(launches, got)
    i2v_cfg = dataclasses.replace(sched_cfg, chunk_num=2, chunk_offset=1)
    fwd, unc, _ = walk_forwards(i2v_cfg, rt, pipe.statics.spec.max_tokens, ct, prefix=1)
    want = {"flash_attention_prefix": 2 * mcfg.num_layers * (fwd + unc)}
    print(f"magi-4.5B I2V (a 720x720 image encoded in {enc_s:.3f} s to {list(prefix.shape)}, "
          f"one chunk generated): {i2v_s:.3f} s, pixels {list(px.shape)}; launches {got} "
          f"(the code implies {want}: 1 prefix-extraction forward, {fwd - 1} chunk forwards, "
          f"{unc} uncond)", flush=True)
    gate(got == want and tuple(px.shape) == (1, fpc, *hw, 3)
         and torch.isfinite(px).all().item(), "I2V run")
    del px, prefix, pipe
    torch.cuda.empty_cache()
    phase("magi-4.5B pipeline", t0)
    return launches, cap, mask


def magi_e4m3_tree(params: dict, cfg: MagiModelConfig, g) -> dict:
    """The fp8 distill-quant layout of a bf16 MAGI tree at full depth:
    `blocks_first` / `blocks_last` its layers 0 and L-1, `blocks_mid` the
    other layers with MAGI_FP8_LINEARS as e4m3 codes and one weight scale a
    layer (absmax / 448); q, qx, k, v, fc1 per-tensor (act_scale 0.02),
    proj and fc2 per-channel (smooth_scale U(0.75, 1.25), input_scale 1)."""
    blocks, L = params["blocks"], cfg.num_layers
    mid = tree_map(lambda a: a[1:L - 1], blocks)
    for name in MAGI_FP8_LINEARS:
        w = blocks[name]["w"][1:L - 1]
        w_q = torch.empty(w.shape, dtype=FP8, device=w.device)
        ws = torch.empty(L - 2, device=w.device)
        for i in range(L - 2):
            ws[i] = w[i].float().abs().max() / 448.0
            w_q[i] = (w[i].float() / ws[i]).to(FP8)
        d = {"w_q": w_q, "weight_scale": ws}
        if name in MAGI_FP8_PER_CHANNEL:
            d["smooth_scale"] = torch.rand(L - 2, w.shape[1], generator=g, device=w.device) \
                * 0.5 + 0.75
            d["input_scale"] = torch.ones(L - 2, device=w.device)
        else:
            d["act_scale"] = torch.full((L - 2, w.shape[1]), 0.02, device=w.device)
        mid[name] = d
    tree = {k: v for k, v in params.items() if k != "blocks"}
    tree.update(blocks_first=layer_params(blocks, 0), blocks_mid=mid,
                blocks_last=layer_params(blocks, L - 1))
    return tree


def magi_fold_bf16(tree: dict) -> dict:
    """The e4m3 tree's linear maps in bf16 without the activation
    quantization: each e4m3 linear as {"w": w_q * weight_scale, rows scaled
    by input_scale / smooth_scale for the per-channel ones}, the fold of
    `magi_distill_quant_to_int8`, a layer at a time."""
    mid = dict(tree["blocks_mid"])
    for name in MAGI_FP8_LINEARS:
        d = mid[name]
        w = torch.empty(d["w_q"].shape, dtype=torch.bfloat16, device=d["w_q"].device)
        for i in range(w.shape[0]):
            wf = d["w_q"][i].float() * d["weight_scale"][i]
            if "smooth_scale" in d:
                wf = wf * (d["input_scale"][i] / d["smooth_scale"][i])[:, None]
            w[i] = wf.to(torch.bfloat16)
        mid[name] = {"w": w}
    return {**tree, "blocks_mid": mid}


def magi_distill_phase(dev: torch.device, smi: str, params: dict, cap, mask) -> dict:
    """Phase 32: magi_4p5b_distill_quant.json (cfg_number 1, distill,
    shortcut_mode "8,16,16", quantize_kv) at full width and depth: phase
    27's tree in the fp8 distill layout, requantized by
    `magi_distill_quant_to_int8` to W8A8 over the int8 window cache (B2,
    B3, B4, B1 cross): a walk of 4 chunks, MAGI_DISTILL_STEPS steps, its
    launches against the code's count with the nearly-clean re-mix's extra
    chunks; each window's velocity against the same walk in bf16 (the e4m3
    tree's folded linears, a bf16 cache), distill_dt_factor in both.
    Returns the W8A8 walk's launches."""
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(32)
    mcfg, rt = magi_config_from_json(os.path.join(REPO, "examples", "configs",
                                                  "magi_4p5b_distill_quant.json"))
    rt.num_steps = MAGI_DISTILL_STEPS
    chunk_num = MAGI_WALK["chunk_num"]
    e4m3 = magi_e4m3_tree(params, mcfg, g)
    trees = {"w8a8": magi_distill_quant_to_int8(e4m3), "bf16": magi_fold_bf16(e4m3)}
    del e4m3
    torch.cuda.empty_cache()
    gate(trees["w8a8"]["blocks_mid"]["q"]["w_q"].dtype == torch.int8, "requantized to int8")
    int8_linears = sum(1 for b in (trees["w8a8"]["blocks_first"], trees["w8a8"]["blocks_last"])
                       for v in b.values() if isinstance(v, dict) and "w_q" in v) \
        + len(MAGI_FP8_LINEARS) * (mcfg.num_layers - 2)
    print(f"magi-4.5B distill-quant: the e4m3 layout (layers 1-{mcfg.num_layers - 2}) "
          f"requantized to W8A8, {memory_bytes(trees['w8a8']['blocks_mid']) / 1e9:.3f} GB of "
          f"middle blocks; {int8_linears} int8 linears a forward", flush=True)
    vels, launches = {}, {}
    for name in ("w8a8", "bf16"):
        pipe = MagiPipeline(mcfg, dataclasses.replace(rt, quantize_kv=name == "w8a8"),
                            params=trees[name], latent_h=MAGI_720[0], latent_w=MAGI_720[1],
                            max_chunks=chunk_num + 1, device=dev)
        ct, cw = pipe.statics.geo.chunk_tokens, pipe.statics.geo.chunk_width
        rec = vels[name] = []
        fwd_window = pipe._forward_window

        def recorded(*args, _f=fwd_window, _r=rec, **kwargs):
            v, c = _f(*args, **kwargs)
            _r.append(v.float().cpu())
            return v, c

        pipe._forward_window = recorded
        reset_counts()
        chunks, secs = timed(lambda: list(pipe.generate_chunks(
            cap, mask, chunk_num, generator=torch.Generator(device=dev).manual_seed(rt.seed))))
        got = since_reset()
        sched_cfg = MagiScheduleConfig(
            chunk_num=chunk_num, chunk_width=cw, window_size=rt.window_size,
            num_steps=rt.num_steps, shortcut_mode=rt.shortcut_mode,
            noise2clean_kvrange=rt.noise2clean_kvrange,
            clean_chunk_kvrange=rt.clean_chunk_kvrange)
        fwd, _, remix = walk_forwards(sched_cfg, rt, pipe.statics.spec.max_tokens, ct)
        L = mcfg.num_layers
        if name == "w8a8":
            want = {"flash_attention_prefix": L * fwd, "flash_attention_prefix_quant": L * fwd,
                    "int8_matmul": int8_linears * fwd,
                    "quantize_rows_int8": (int8_linears + 2 * L) * fwd}
            add_counts(launches, got)
        else:
            want = {"flash_attention_prefix": 2 * L * fwd}
        print(f"magi-4.5B distill-quant walk, {name} ({chunk_num} chunks, {rt.num_steps} steps, "
              f"distill_dt_factor {pipe._distill_dt_factor(1.0):g}): {secs:.3f} s, "
              f"{len(rec)} windows; launches {got} (the code implies {want}: {fwd} chunk "
              f"forwards, {remix} of them the nearly-clean re-mix's extra chunk)", flush=True)
        gate(got == want and remix > 0, f"distill-quant {name} launches and re-mix")
        gate(len(chunks) == chunk_num and all(torch.isfinite(c).all().item() for _, c in chunks),
             f"distill-quant {name} chunks")
        del pipe._forward_window, pipe, chunks   # the recorder refers to the pipeline
        torch.cuda.empty_cache()
    errs = step_errors(vels["w8a8"], vels["bf16"])
    print(f"magi-4.5B distill-quant W8A8 + int8 cache against the bf16 walk: velocity rel err "
          f"by window {['%.3e' % e for e in errs]} (tol {MAGI_W8A8_RTOL:g})", flush=True)
    gate(max(errs) <= MAGI_W8A8_RTOL, "distill-quant W8A8 against bf16")
    del trees, vels
    torch.cuda.empty_cache()
    phase("magi-4.5B distill-quant", t0)
    return launches


def magi_24b_pipeline_phase(dev: torch.device, smi: str, vae, cap, mask,
                            full_bytes: int) -> dict:
    """Phase 33: MagiVideoPipeline on magi_24b.json's widths at
    MAGI_24B_LAYERS of 48 layers: W8A8, the int8 window cache, 3-CFG,
    per-chunk dispatch, 720x1280, 2 chunks, the 16-channel latents decoded
    by phase 30's z-16 VAE: finite pixels, the rows synced after each
    window, launches against the code's count, peak device bytes beside
    phase 29's worked-out full depth. Returns the launches."""
    t0 = time.perf_counter()
    full, rt = magi_config_from_json(os.path.join(REPO, "examples", "configs", "magi_24b.json"))
    cfg = dataclasses.replace(full, num_layers=MAGI_24B_LAYERS)
    rt.num_steps = MAGI_PIPE_STEPS
    g = torch.Generator(device=dev).manual_seed(33)
    params = magi_quantize_params_int8(init_magi_params(cfg, g, dev))
    torch.cuda.empty_cache()
    rt.quantize_kv = True
    pipe = MagiVideoPipeline(cfg, rt, params=params, latent_h=MAGI_720x1280[0],
                             latent_w=MAGI_720x1280[1], max_chunks=2, device=dev, vae=vae)
    ct, cw = pipe.statics.geo.chunk_tokens, pipe.statics.geo.chunk_width
    sched_cfg = MagiScheduleConfig(chunk_num=2, chunk_width=cw, window_size=rt.window_size,
                                   num_steps=rt.num_steps,
                                   noise2clean_kvrange=rt.noise2clean_kvrange,
                                   clean_chunk_kvrange=rt.clean_chunk_kvrange)
    synced = []
    pipe.generate_chunks = functools.partial(
        pipe.generate_chunks, state_callback=row_sync_checker(sched_cfg, ct, synced, {}))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    video, secs = timed(lambda: pipe.generate_video(cap, mask, 2))
    got = since_reset()
    peak = torch.cuda.max_memory_allocated(dev)
    fwd, unc, _ = walk_forwards(sched_cfg, rt, pipe.statics.spec.max_tokens, ct)
    L = cfg.num_layers
    want = {"flash_attention_prefix_quant": L * fwd, "flash_attention_prefix": L * (fwd + 2 * unc),
            "int8_matmul": 8 * L * (fwd + unc), "quantize_rows_int8": 8 * L * (fwd + unc) + 2 * L * fwd}
    print(f"magi-24B widths ({MAGI_24B_LAYERS} of {full.num_layers} layers) MagiVideoPipeline, "
          f"W8A8 + int8 cache, 3-CFG, 2 chunks at 720x1280, {rt.num_steps} steps: {secs:.3f} s, "
          f"pixels {list(video.shape)}; launches {got} (the code implies {want}: {fwd} chunk "
          f"forwards at B=2, {unc} uncond); peak device bytes {peak / 1e9:.3f} GB "
          f"({(peak - base) / 1e9:.3f} above the resident {base / 1e9:.3f}); phase 29's full "
          f"depth worked out: {full_bytes / 1e9:.3f} GB resident", flush=True)
    hw = tuple(vae.cfg.patch_size * n for n in MAGI_720x1280)
    gate(tuple(video.shape) == (1, 2 * cw * vae.cfg.patch_length, *hw, 3)
         and torch.isfinite(video).all().item()
         and len(synced) > 0 and all(synced) and got == want,
         "24B pipeline: finite pixels, rows synced, launches")
    del video, pipe.generate_chunks, pipe, params   # the checker's partial refers to the pipeline
    torch.cuda.empty_cache()
    phase("magi-24B pipeline", t0)
    return got


def reference_vitvae_sd(params: dict, cfg: ViTVAEConfig) -> dict:
    """This script's inverse of `convert_magi_vae_state_dict`: the ViT-VAE
    tree as a reference `ViTVAE` state dict on the host."""
    sd = {}

    def lin(name, p, i=None):
        sd[f"{name}.weight"] = host_copy((p["w"] if i is None else p["w"][i]).t())
        if "b" in p:
            sd[f"{name}.bias"] = host_copy(p["b"] if i is None else p["b"][i])

    def ln(name, p, i=None):
        for k, n in (("w", "weight"), ("b", "bias")):
            sd[f"{name}.{n}"] = host_copy(p[k] if i is None else p[k][i])

    for side in ("encoder", "decoder"):
        t = params[side]
        sd[f"{side}.pos_embed"] = host_copy(t["pos_embed"][None])
        sd[f"{side}.cls_token"] = host_copy(t["cls_token"].reshape(1, 1, -1))
        b = t["blocks"]
        for i in range(cfg.depth):
            pre = f"{side}.blocks.{i}"
            lin(f"{pre}.attn.qkv", b["qkv"], i)
            lin(f"{pre}.attn.proj", b["proj"], i)
            ln(f"{pre}.norm2", b["norm2"], i)
            lin(f"{pre}.mlp.fc1", b["fc1"], i)
            lin(f"{pre}.mlp.fc2", b["fc2"], i)
        ln(f"{side}.norm", t["norm"])
    enc, dec = params["encoder"], params["decoder"]
    d = cfg.embed_dim
    sd["encoder.patch_embed.proj.weight"] = host_copy(enc["patch"]["w"].t().reshape(
        d, cfg.in_chans, cfg.patch_length, cfg.patch_size, cfg.patch_size))
    sd["encoder.patch_embed.proj.bias"] = host_copy(enc["patch"]["b"])
    lin("encoder.last_layer", enc["last"])
    lin("decoder.proj_in", dec["proj_in"])
    lin("decoder.final_proj", dec["final_proj"])
    ln("decoder.final_norm", dec["final_norm"])
    sd["decoder.last_layer.weight"] = host_copy(dec["last_conv"]["w"].permute(4, 3, 0, 1, 2))
    sd["decoder.last_layer.bias"] = host_copy(dec["last_conv"]["b"])
    return sd


def magi_cli_phase(dev: torch.device, smi: str, vae, out_dir: str) -> dict:
    """Phase 34: `python -m inferix_tpu_torch.cli magi` in a subprocess from
    files this phase writes: magi_4p5b.json cut to MAGI_CLI_LAYERS layers,
    a seeded reference-format .pt at that depth, and phase 30's VAE as a
    config.json + safetensors directory (this script's writer); 2 chunks, 4
    steps. Exit 0, and frames [48, 720, 720, 3] uint8 equal to the same run
    in this process (the walk from the converted .pt, the VAE from
    `load_magi_vae`). Returns the in-process run's launches."""
    t0 = time.perf_counter()
    with open(os.path.join(REPO, "examples", "configs", "magi_4p5b.json")) as f:
        conf = json.load(f)
    conf["model"]["num_layers"] = MAGI_CLI_LAYERS
    cfg_path = os.path.join(out_dir, "magi_cli.json")
    with open(cfg_path, "w") as f:
        json.dump(conf, f)
    mcfg = MagiModelConfig(**conf["model"])
    g = torch.Generator(device=dev).manual_seed(34)
    pt = os.path.join(out_dir, "magi_cli.pt")
    torch.save(magi_reference_sd(init_magi_params(mcfg, g, dev), mcfg), pt)
    vae_dir = os.path.join(out_dir, "magi_vae")
    os.makedirs(vae_dir)
    vcfg = vae.cfg
    with open(os.path.join(vae_dir, "config.json"), "w") as f:
        json.dump({"ddconfig": {k: getattr(vcfg, k) for k in (
            "video_size", "video_length", "patch_size", "patch_length", "z_chans",
            "embed_dim", "depth", "num_heads")}}, f)
    nbytes = write_safetensors(os.path.join(vae_dir, "diffusion_pytorch_model.safetensors"),
                               reference_vitvae_sd(vae.params, vcfg))
    out = os.path.join(out_dir, "magi.npz")
    frames, wall = cli(["magi", "--config", cfg_path, "--load", pt, "--vae", vae_dir,
                        "--chunks", "2", "--num-steps", "4", "--output", out])
    reset_counts()
    with torch_defaults():
        m2, rt = magi_config_from_json(cfg_path)
        rt.num_steps, rt.seed = 4, 42
        tree = convert_magi_state_dict(load_torch_state_dict(pt), m2, torch.bfloat16, dev)
        pipe = MagiPipeline(m2, rt, params=tree, latent_h=MAGI_720[0], latent_w=MAGI_720[1],
                            max_chunks=4, device=dev)
        vae2 = load_magi_vae(vae_dir, device=dev)
        cap = torch.zeros(1, m2.caption_max_length, m2.caption_channels, device=dev)
        cmask = torch.ones(1, m2.caption_max_length, dtype=torch.int32, device=dev)
        px, inproc_s = timed(lambda: [vae2.decode(c) for _, c in pipe.generate_chunks(
            cap, cmask, 2)])
        want = latents_to_uint8((torch.cat(px, dim=1)[0] * 0.5 + 0.5).float().cpu().numpy())
    got = since_reset()
    n_px = 2 * m2.chunk_width * vae.cfg.patch_length
    equal = frames.shape == want.shape == (n_px, *(vcfg.patch_size * n for n in MAGI_720), 3) \
        and np.array_equal(frames, want)
    print(f"cli: magi from files (a {MAGI_CLI_LAYERS}-layer .pt, the VAE's "
          f"{nbytes / 1e9:.3f} GB safetensors): exit 0 in {wall:.3f} s, frames "
          f"{frames.shape} {frames.dtype} equal to the in-process run ({inproc_s:.3f} s) "
          f"{equal}; launches in process {got}; {smi}", flush=True)
    gate(equal, "the magi command's frames differ from the in-process run's")
    del pipe, tree, vae2, px
    torch.cuda.empty_cache()
    phase("magi cli", t0)
    return got


@contextlib.contextmanager
def torch_defaults():
    """PyTorch's default TF32 switches (what a fresh process such as the
    CLI runs with), for the run compared with the CLI's output."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def cli(args: list) -> tuple:
    """`python -m inferix_tpu_torch.cli <args>` in a subprocess from the
    checkout; returns (frames of its .npz output, wall seconds)."""
    env = {**os.environ, "PYTHONPATH": REPO}
    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "inferix_tpu_torch.cli", *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t1
    print(f"cli: {' '.join(args)}: exit {res.returncode} in {wall:.3f} s; its output: "
          f"{res.stdout.strip().splitlines()[-2:]}", flush=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], flush=True)
    gate(res.returncode == 0, f"the CLI exited {res.returncode}: {args}")
    out = [a for i, a in enumerate(args) if i and args[i - 1] == "--output"][0]
    return np.load(out)["frames"], wall


def cli_phase(dev: torch.device, smi: str, ckpt_dir: str, out_dir: str) -> dict:
    """Phase 25: the port's CLI on the card in subprocesses. self-forcing
    with phase 22's checkpoint, W8A8, CLI_FRAMES latent frames: exit 0,
    frames [21, 480, 832, 3] uint8 equal to an in-process run_text_to_video
    on the same config and seed; then stream (file backend, 2 segments) and
    causvid (2 rollouts) at --tiny: exit 0 and their frame counts."""
    t0 = time.perf_counter()
    sf = os.path.join(out_dir, "sf.npz")
    frames, sf_s = cli(["self-forcing", "--model-path", ckpt_dir, "--quant", "int8",
                        "--frames", str(CLI_FRAMES), "--output", sf])
    cfg = EngineConfig()
    cfg.model_path, cfg.runtime.seed = ckpt_dir, 42
    cfg.quant.enabled, cfg.quant.dtype = True, "int8"
    reset_counts()
    with torch_defaults():
        pipe = SelfForcingPipeline(cfg, device=dev)
        video, inproc_s = timed(lambda: pipe.run_text_to_video([CLI_PROMPT],
                                                               num_frames=CLI_FRAMES))
    path = since_reset()
    want = latents_to_uint8(video.float().cpu().numpy())
    del pipe, video
    pix = 1 + 4 * (CLI_FRAMES - 1)
    equal = frames.dtype == np.uint8 and frames.shape == want.shape \
        and np.array_equal(frames, want)
    print(f"cli: self-forcing frames {frames.shape} {frames.dtype} equal to the in-process "
          f"run_text_to_video ({inproc_s:.3f} s) {equal}; {smi}", flush=True)
    gate(frames.shape == (pix, 480, 832, 3) and equal,
         "the CLI's frames differ from the in-process pipeline's")
    torch.cuda.empty_cache()
    counts_ok = []
    for args, n_frames in ((["stream", "--tiny", "--backend", "file", "--segments", "2"], 22),
                           (["causvid", "--tiny", "--rollouts", "2"], 17)):
        got, _ = cli(args + ["--output", os.path.join(out_dir, f"{args[0]}.npz")])
        counts_ok.append(got.shape[0] == n_frames)
        print(f"cli: {args[0]} --tiny on the card: {got.shape[0]} frames (want {n_frames})",
              flush=True)
    gate(all(counts_ok),
         "a tiny CLI command wrote the wrong number of frames")
    phase("cli", t0)
    return path


EVAL_CHUNKS = 7          # phase 35: vde chunks of a 21-frame clip, 3 frames each
EVAL_SEED = 35           # phase 35: the seeded RAFT and AMT-S weights
EVAL_CPU_THREADS = 6     # phase 35: CPU threads of the reference scoring, beside the commands
# Phase 35's card-against-CPU gates, float32 with TF32 off on both sides. A
# 1e-7 relative perturbation of the inputs moved a pair's RAFT score by at
# most 9e-8 relative on the CPU (480x832, 20 iterations, seeded weights) and
# flipped 1.3e-5 of AMT-S's uint8 codes; the card's convolutions sum in other
# orders, so the gates leave two to three orders of room over that noise.
RAFT_RTOL = 1e-3         # each pair's mean top-5% flow magnitude, relative
AMT_CODE_TOL = 1e-2      # mean |code difference| of the interpolated frames, in codes
PIPE_CAPACITY = 8        # the frame pipe's ring, for the 21 frames of the clip
LAPLACIAN_RTOL = 1e-9    # native laplacian_var against the numpy reference


@contextlib.contextmanager
def tf32_on():
    """TF32 in cuBLAS and cuDNN (PyTorch's defaults allow it in cuDNN), for
    the gap printed beside the gated TF32-off run."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def write_eval_weights(out_dir: str) -> tuple:
    """Seeded RAFT and AMT-S checkpoints in the official layouts: RAFT's keys
    under DataParallel's `module.` prefix (raft-things.pth), AMT-S's under
    "state_dict" (amt-s.pth)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(EVAL_SEED)
        raft_sd, amt_sd = RAFT().state_dict(), AMTS().state_dict()
    raft_path, amt_path = (os.path.join(out_dir, n) for n in ("raft-things.pth", "amt-s.pth"))
    torch.save({f"module.{k}": v for k, v in raft_sd.items()}, raft_path)
    torch.save({"state_dict": amt_sd}, amt_path)
    return raft_path, amt_path


def cpu_eval_scores(raft_path: str, amt_path: str, video: np.ndarray) -> dict:
    """RAFT's pair scores and AMT-S's interpolations of `video` on the CPU,
    from the same files through the same classes."""
    torch.set_num_threads(EVAL_CPU_THREADS)
    raft = RAFTDynamicDegree(raft_path, device="cpu")
    amt = AMTMotionSmoothness(amt_path, device="cpu")
    t1 = time.perf_counter()
    scores, thres = raft.pair_scores(video)
    t2 = time.perf_counter()
    actual, interp = amt.motion.interpolate(video)
    return {"scores": scores, "thres": thres, "actual": actual, "interp": interp,
            "raft_s": t2 - t1, "amt_s": time.perf_counter() - t2}


def vde_start(args: list) -> tuple:
    """`python -m inferix_tpu_torch.cli vde <args>` started in a subprocess."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-m", "inferix_tpu_torch.cli", "vde", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), args


def vde_wait(job: tuple) -> tuple:
    """(the JSON the vde command wrote, its wall seconds); exit 0 gated."""
    proc, t1, args = job
    out, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t1
    print(f"cli: vde {' '.join(args)}: exit {proc.returncode} in {wall:.3f} s", flush=True)
    if proc.returncode != 0:
        print(err[-4000:], flush=True)
    gate(proc.returncode == 0, f"the vde command exited {proc.returncode}: {args}")
    with open(args[args.index("--output") + 1]) as f:
        return json.load(f), wall


def unit_frames(path: str) -> np.ndarray:
    return np.load(path)["frames"].astype(np.float32) / 255.0


def eval_phase(dev: torch.device, smi: str, ckpt_dir: str, out_dir: str) -> None:
    """Phase 35: the evaluation path. The vde command over phase 25's W8A8
    clip (sf.npz, 21 frames at 480x832) equal to the in-process
    evaluate_video; the self-forcing command again in bf16 and with fp8
    weights (phase 22's checkpoint, the same seed and CLI_FRAMES), and
    `vde --compare` of the W8A8 and the fp8 clip against the bf16 one equal
    to the in-process quality_delta; RAFTDynamicDegree and
    AMTMotionSmoothness from seeded weight files on the card (their
    default device) against the same classes on the CPU, timed, with peak
    device bytes; the native frame pipe. Host work runs beside the card's:
    the first vde command beside the card's scoring, the CPU scoring in a
    thread beside the commands, the in-process references in threads beside
    the compare commands."""
    t0 = time.perf_counter()
    sf = os.path.join(out_dir, "sf.npz")
    clip = np.load(sf)["frames"]
    video = clip.astype(np.float32) / 255.0
    jobs, threads = [], torch.get_num_threads()
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        jobs.append(vde_start([sf, "--chunks", str(EVAL_CHUNKS), "--output",
                               os.path.join(out_dir, "vde.json")]))
        raft_path, amt_path = write_eval_weights(out_dir)
        raft, amt = RAFTDynamicDegree(raft_path), AMTMotionSmoothness(amt_path)
        gate(all(p.is_cuda for p in raft.model.parameters())
             and all(p.is_cuda for p in amt.motion.model.parameters()),
             "the metric classes' default device is not the card")
        raft.pair_scores(video[:2])  # warm-up: cuDNN handles, lazy modules
        amt.motion.interpolate(video[:3])
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (scores, thres), raft_s = timed(lambda: raft.pair_scores(video))
        raft_peak = peak_since(dev, base)
        torch.cuda.reset_peak_memory_stats(dev)
        (actual, interp), amt_s = timed(lambda: amt.motion.interpolate(video))
        amt_peak = peak_since(dev, base)
        with tf32_on():
            scores_tf32, _ = raft.pair_scores(video)
            _, interp_tf32 = amt.motion.interpolate(video)
        del raft, amt
        torch.cuda.empty_cache()
        n_pairs, n_interp = len(scores), len(interp)
        print(f"eval: RAFT (20 iterations) on the card {raft_s:.3f} s a clip of {n_pairs} pairs, "
              f"{raft_s / n_pairs * 1e3:.3f} ms a pair, peak {raft_peak / 1e9:.3f} GB above the "
              f"resident; AMT-S {amt_s:.3f} s for {n_interp} interpolations, "
              f"{amt_s / n_interp * 1e3:.3f} ms each, peak {amt_peak / 1e9:.3f} GB; {smi}",
              flush=True)
        finite = all(np.isfinite(s) for s in scores + scores_tf32)
        print(f"eval: RAFT's flow finite with the seeded weights: {finite}", flush=True)
        gate(finite, "RAFT's flow is not finite with the seeded weights")
        cpu = pool.submit(cpu_eval_scores, raft_path, amt_path, video)

        clips = {"w8a8": sf}
        for quant in ("none", "fp8"):
            clips[quant] = os.path.join(out_dir, f"sf_{quant}.npz")
            frames, _ = cli(["self-forcing", "--model-path", ckpt_dir, "--quant", quant,
                             "--frames", str(CLI_FRAMES), "--output", clips[quant]])
            gate(frames.dtype == np.uint8 and frames.shape == clip.shape,
                 f"the --quant {quant} clip is {frames.shape} {frames.dtype}, not {clip.shape}")
        drift, vde_s = vde_wait(jobs.pop(0))

        register_flow_metrics()
        units = {q: unit_frames(p) for q, p in clips.items()}
        inproc = {"drift": pool.submit(evaluate_video, units["w8a8"], n_chunks=EVAL_CHUNKS)}
        cmp_jobs = {}
        for q in ("w8a8", "fp8"):
            cmp_jobs[q] = vde_start([clips[q], "--compare", clips["none"], "--chunks",
                                     str(EVAL_CHUNKS), "--output",
                                     os.path.join(out_dir, f"delta_{q}.json")])
            jobs.append(cmp_jobs[q])
            inproc[q] = pool.submit(quality_delta, units[q], units["none"], n_chunks=EVAL_CHUNKS)
        want = {k: f.result() for k, f in inproc.items()}
        deltas = {}
        for q, job in cmp_jobs.items():
            deltas[q], _ = vde_wait(job)
            jobs.remove(job)
        ref = cpu.result()
    finally:
        for proc, _, _ in jobs:
            proc.kill()
            proc.wait()
        pool.shutdown(wait=True)
        torch.set_num_threads(threads)

    print(f"eval: vde --chunks {EVAL_CHUNKS} of the W8A8 clip ({vde_s:.3f} s of wall, beside "
          f"the card's scoring): {json.dumps(drift[sf])}", flush=True)
    gate(all(np.isfinite(v) for v in drift[sf].values()), "a vde drift is not finite")
    gate(drift == {sf: want["drift"]},
         "the vde command's JSON differs from the in-process evaluate_video")
    for q in ("w8a8", "fp8"):
        print(f"eval: quality delta of the {q} clip against the bf16 clip (seeded random "
              f"weights): {json.dumps(deltas[q][clips[q]])}", flush=True)
        gate(deltas[q] == {clips[q]: want[q]},
             f"vde --compare of the {q} clip differs from the in-process quality_delta")

    rel = [abs(a - b) / abs(b) for a, b in zip(scores, ref["scores"])]
    rel_tf32 = [abs(a - b) / abs(b) for a, b in zip(scores_tf32, ref["scores"])]
    moving = sum(s > thres for s in scores) / n_pairs
    moving_cpu = sum(s > ref["thres"] for s in ref["scores"]) / n_pairs
    near = [i for i, s in enumerate(ref["scores"]) if abs(s - thres) <= RAFT_RTOL * thres]
    print(f"eval: RAFT pair scores (mean top-5% flow, px) card {min(scores):.4f} to "
          f"{max(scores):.4f}, threshold {thres:.4f}, moving {moving:.4f} (CPU {moving_cpu:.4f}, "
          f"{ref['raft_s']:.3f} s on {EVAL_CPU_THREADS} threads); card against CPU max rel "
          f"{max(rel):.3e} (tol {RAFT_RTOL:g}), with TF32 {max(rel_tf32):.3e} (not gated); "
          f"pairs within the tolerance of the threshold: {near}", flush=True)
    gate(max(rel) <= RAFT_RTOL and ref["thres"] == thres,
         "RAFT's pair scores on the card differ from the CPU's")
    gate(moving == moving_cpu or bool(near), "RAFT's moving fraction differs from the CPU's")
    diff = np.abs(interp.astype(np.int16) - ref["interp"].astype(np.int16))
    diff_tf32 = np.abs(interp_tf32.astype(np.int16) - ref["interp"].astype(np.int16))
    smooth, smooth_cpu = smoothness_score(actual, interp), smoothness_score(ref["actual"],
                                                                              ref["interp"])
    print(f"eval: AMT-S motion smoothness card {smooth:.9f}, CPU {smooth_cpu:.9f} "
          f"({ref['amt_s']:.3f} s); interpolated codes differing {float((diff > 0).mean()):.3e} "
          f"of them, max {int(diff.max())}, mean {float(diff.mean()):.3e} codes "
          f"(tol {AMT_CODE_TOL:g}); with TF32 {float((diff_tf32 > 0).mean()):.3e} differing, "
          f"mean {float(diff_tf32.mean()):.3e} (not gated)", flush=True)
    gate(np.array_equal(actual, ref["actual"]) and float(diff.mean()) <= AMT_CODE_TOL
         and abs(smooth - smooth_cpu) <= AMT_CODE_TOL / 255.0,
         "AMT-S's interpolations on the card differ from the CPU's")

    t1 = time.perf_counter()
    native_mod.get_lib()
    build_s = time.perf_counter() - t1
    pipe = native_mod.FramePipe(PIPE_CAPACITY, *clip.shape[1:])
    t1 = time.perf_counter()
    pushed = [pipe.push(f) for f in clip]
    push_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    popped = [pipe.pop() for _ in range(PIPE_CAPACITY + 1)]
    pop_s = time.perf_counter() - t1
    fifo = popped[-1] is None and all(np.array_equal(p, f)
                                      for p, f in zip(popped[:PIPE_CAPACITY], clip))
    gate(pushed == [True] * PIPE_CAPACITY + [False] * (len(clip) - PIPE_CAPACITY)
         and pipe.dropped == len(clip) - PIPE_CAPACITY and fifo and len(pipe) == 0,
         "the frame pipe's FIFO order or drop count is wrong")
    (i420, i420_s), (i420_ref, i420_ref_s) = (
        timed_host(lambda fn=fn: [fn(f) for f in clip])
        for fn in (native_mod.rgb_to_i420, native_mod.rgb_to_i420_reference))
    (lap, lap_s), (lap_ref, lap_ref_s) = (
        timed_host(lambda fn=fn: [fn(f) for f in clip])
        for fn in (native_mod.laplacian_var, native_mod.laplacian_var_reference))
    i420_equal = all(np.array_equal(a, b) for fa, fb in zip(i420, i420_ref)
                     for a, b in zip(fa, fb))
    lap_rel = max(abs(a - b) / abs(b) for a, b in zip(lap, lap_ref))
    print(f"eval: frame pipe built in {build_s:.3f} s; {len(clip)} frames pushed into a ring of "
          f"{PIPE_CAPACITY}: {pipe.dropped} dropped, FIFO {fifo}, {push_s / len(clip) * 1e3:.3f} "
          f"ms a push, {pop_s / (PIPE_CAPACITY + 1) * 1e3:.3f} ms a pop; rgb_to_i420 "
          f"{i420_s / len(clip) * 1e3:.3f} ms a frame (numpy {i420_ref_s / len(clip) * 1e3:.3f}), "
          f"bit-equal {i420_equal}; laplacian_var {lap_s / len(clip) * 1e3:.3f} ms (numpy "
          f"{lap_ref_s / len(clip) * 1e3:.3f}), max rel {lap_rel:.3e} (tol {LAPLACIAN_RTOL:g}); "
          f"{smi}", flush=True)
    gate(i420_equal and lap_rel <= LAPLACIAN_RTOL,
         "the native rgb_to_i420 / laplacian_var differ from their references")
    phase("eval", t0)


def timed_host(fn):
    """(fn(), seconds) on the host clock."""
    t1 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=2,
                    help="3-frame blocks to generate, 1..7 (default 2)")
    args = ap.parse_args()
    if not 1 <= args.blocks <= 7:
        raise SystemExit("--blocks must be in 1..7")
    t_all = time.perf_counter()
    # fp32 matmuls of the plain versions in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = device_phase(dev)
    torch.cuda.set_device(dev)
    phase("device", t0)

    t0 = time.perf_counter()
    _build.build(LIBRARIES, verbose=True)
    for name in LIBRARIES:
        _build.load_library(name)
    phase("build", t0)

    t0 = time.perf_counter()
    entry = kernel_phase(dev)
    phase("kernels", t0)

    bf16_launches = main_path_phase(dev, main_path_config(args.blocks))

    t0 = time.perf_counter()
    entries = [entry] + w8a8_kernel_phase(dev)
    phase("w8a8 kernels", t0)

    total = w8a8_main_phase(dev, args.blocks)
    entries[0]["launches"] = total["flash_attention_prefix"]
    entries[1]["launches"] = total["int8_matmul"]
    entries[2]["launches"] = total["quantize_rows_int8"]
    entries[3]["launches"] = total["adaln"] + total["ln"]
    print(f"launches on the main paths: bf16 flash_attention_prefix {bf16_launches}; "
          f"W8A8 {total}", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fp8_entry = fp8w_kernel_phase(dev)
    phase("fp8w kernels", t0)
    fp8_total = fp8w_main_phase(dev, args.blocks)
    fp8_entry["launches"] = fp8_total["fp8_matmul"]
    entries[0]["launches"] += fp8_total["flash_attention_prefix"]
    print(f"launches on the fp8w path: {count_diff(fp8_total, {k: 0 for k in fp8_total})}",
          flush=True)

    t0 = time.perf_counter()
    kv_entries = kv_kernel_phase(dev)
    phase("kv kernels", t0)
    t0 = time.perf_counter()
    qattn_entries = quant_attention_kernel_phase(dev)
    phase("quant-attention kernels", t0)
    paths = {}
    for path in ("int8_b2", "window", "fp8"):
        paths[path], latents = kv_path_phase(dev, path)
    kv_entries[0]["launches"] = (paths["int8_b2"]["flash_attention_prefix_quant"]
                                 + paths["window"]["flash_attention_prefix_quant"])
    kv_entries[1]["launches"] = paths["fp8"]["flash_attention_prefix_fp8"]
    entries[2]["launches"] += (paths["int8_b2"]["quantize_rows_int8"]
                               + paths["window"]["quantize_rows_int8"])

    t0 = time.perf_counter()
    vae_entries = vae_kernel_phase(dev)
    phase("vae kernels", t0)
    decode = vae_decode_phase(dev, latents)
    encode, prefix = vae_encode_phase(dev)
    pipe = pipeline_phase(dev, smi, prefix)
    enc, clip_features = text_encoder_phase(dev, smi)
    p17 = umt5_pipeline_phase(dev, smi, enc)
    p18 = cfg_phase(dev, smi, enc)
    del enc
    torch.cuda.empty_cache()
    p19 = causvid_phase(dev, smi)
    p20 = continuous_phase(dev, smi)
    p21 = i2v_phase(dev, smi, clip_features)
    del clip_features
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt_dir, out_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
        os.makedirs(ckpt_dir)
        os.makedirs(out_dir)
        seeded, p22 = files_phase(dev, smi, ckpt_dir)
        p23 = wholeclip_phase(dev, smi, seeded)
        del seeded
        p24 = resume_phase(dev, smi, out_dir)
        p25 = cli_phase(dev, smi, ckpt_dir, out_dir)
        eval_phase(dev, smi, ckpt_dir, out_dir)
    print(f"launches on phases 16-25: umt5 pipeline {p17}; cfg {p18}; causvid {p19}; "
          f"continuous {p20}; i2v-14B {p21}; files {p22}; wholeclip {p23}; resume {p24}; "
          f"cli (in-process) {p25}", flush=True)
    for p in (p17, p18, p19, p20, p21, p22, p23, p24, p25):
        add_counts(pipe, p)
    torch.cuda.empty_cache()
    magi = magi_phases(dev, smi)
    add_counts(pipe, {k: v for k, v in magi.items() if k != "flash_attention_prefix_fp8"})
    kv_entries[1]["launches"] += magi.get("flash_attention_prefix_fp8", 0)
    fp8_entry["launches"] += pipe.get("fp8_matmul", 0)
    vae_entries[0]["launches"] = (decode["halo"]["halo_conv3d"] + encode["halo"]["halo_conv3d"]
                                  + pipe["halo_conv3d"])
    vae_entries[1]["launches"] = (decode["halo_w8a8"]["halo_conv3d_w8a8"]
                                  + encode["halo_w8a8"]["halo_conv3d_w8a8"])
    vae_entries[2]["launches"] = (decode["halo_w8a8"]["quantize_conv_act"]
                                  + encode["halo_w8a8"]["quantize_conv_act"])
    for e, k in ((entries[0], "flash_attention_prefix"), (entries[1], "int8_matmul"),
                 (entries[2], "quantize_rows_int8"), (kv_entries[0], "flash_attention_prefix_quant")):
        e["launches"] += pipe[k]
    entries[3]["launches"] += pipe["adaln"] + pipe["ln"]
    entries += kv_entries + vae_entries + [fp8_entry] + qattn_entries
    print(f"launches on this slice's paths: {paths}; decode {decode}; encode {encode}; "
          f"pipeline {pipe}", flush=True)
    print(f"wall: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
