#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--blocks N]

Phases, each timed on a line of its own:
  1. device   - require a CUDA card; print its name and power limit
                (nvidia-smi), the torch, CUDA and nvcc versions.
  2. build    - build every kernel of the main path from `csrc/` with nvcc
                (-Xptxas -v output above the build time).
  3. kernels  - each kernel against its plain PyTorch version on the card, at
                the main path's shapes, with the stated tolerance; its time
                (CUDA events, median of 10 after warm-up) beside its bound,
                the plain version's time and one library call's time.
  4. main     - Self-Forcing Wan2.1-T2V-1.3B semi-AR generation at full width
                and depth (random weights from a seed, random text features),
                bf16, context_mode "rerun", over N blocks of 3 latent frames
                (default 2) on a 21-frame cache; launch counts per block, the
                output and the cache checked; then one layer and one whole
                forward with the kernel against the same with plain attention.
The second-to-last line is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}. Any failure raises: the script exits
non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

import inferix_tpu_torch.ops.attention as attention_mod
from inferix_tpu_torch import _build
from inferix_tpu_torch.core.config import EngineConfig
from inferix_tpu_torch.models.wan.causal_dit import (
    dit_forward_inference, layer_params, block_forward, patch_embed,
    time_embeddings)
from inferix_tpu_torch.kvcache.cache import valid_mask
from inferix_tpu_torch.ops.flash_attention import (
    flash_attention_prefix, flash_attention_prefix_reference)
from inferix_tpu_torch.ops.rope import rope_angles
from inferix_tpu_torch.pipeline.semi_ar import SemiARGenerator
from inferix_tpu_torch.utils.params import init_params

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

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


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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

    for span in (4680, 9360, 14040, 32760):
        ms = time_ms(lambda: flash_attention_prefix(q, k, v, span))
        bound, by = attention_bound(1, SQ, span)
        print(f"kernel time kv_len {span}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), {4 * SQ * span * H * D / ms / 1e9:.1f} TFLOP/s", flush=True)
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
            "source": "inferix_tpu_torch/csrc/flash_attention_prefix.cu",
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


def main_path_config(blocks: int) -> EngineConfig:
    """Wan2.1-T2V-1.3B, 480x832, bf16, rerun, over `blocks` 3-frame blocks."""
    cfg = EngineConfig()
    cfg.runtime.num_frames = cfg.model.num_frame_per_block * blocks
    return cfg


def main_path_setup(dev: torch.device, cfg: EngineConfig):
    """Random weights, text K/V and initial noise from seed 0. Returns
    (SemiARGenerator, text K/V, noise [1, F, H, W, C], torch.Generator)."""
    m, r = cfg.model, cfg.runtime
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(m, g, device=dev, dtype=torch.bfloat16)
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
    _build.load_library("flash_attention_prefix", verbose=True)
    phase("build", t0)

    t0 = time.perf_counter()
    entry = kernel_phase(dev)
    phase("kernels", t0)

    entry["launches"] = main_path_phase(dev, main_path_config(args.blocks))
    print(f"wall: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
