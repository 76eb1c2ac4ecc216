#!/usr/bin/env python3
"""Where the device time of a Wan2.1-1.3B block or VAE decode chunk goes.

One Self-Forcing block, or one Wan causal-VAE decode chunk, of the PyTorch
port, traced on one CUDA card.

    PYTHONPATH=. python3 exp/torch_op_breakdown.py [--block N] [--w8a8 | --fp8]   # from the repo root
    PYTHONPATH=. python3 exp/torch_op_breakdown.py --vae {xla,halo,halo_w8a8}

Generates blocks 0..N-1 (random weights from a seed, bf16, context_mode
"rerun", full width and depth), then traces block N (4 denoise forwards and
the context re-run, over a live cache of (N+1)*4680 tokens) with
torch.profiler and prints the device time by kernel group and the top
kernels, the device's idle share over the traced window, and one JSON line.
Block 6 (the default) is the last block of a 21-frame clip: its attention
covers the full 32760-token cache. --w8a8 runs chip_smoke.py's W8A8 path
instead (int8 per-channel linears, fused act-quant prologues), --fp8 its fp8
weight-only path (e4m3 per-channel linears through the fp8 GEMM). --vae decodes
6 random latent frames (480x832 pixels, chip_smoke.py's decode weights,
bf16) with the given conv impl and traces the second 3-frame chunk.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import fp8w_config, main_path_config, main_path_setup, vae_params
from inferix_tpu_torch.models.wan.vae import CONV_IMPLS, CausalVAE, VAEConfig
from inferix_tpu_torch.ops.flash_attention import flash_attention_prefix

GROUPS = (  # first match wins
    # one kernel template: K/V kind 0 (bf16) and 1 (e4m3) are B1, 2 (int8) B2
    ("flash_attention_prefix (ours)", re.compile(r"flash_sm90_kernel(<|ILi)[01]")),
    ("flash_attention_prefix_quant (ours)", re.compile(r"flash_sm90_kernel(<|ILi)2")),
    # one GEMM template (csrc/gemm_sm90.cu): kFp8 false is B3, true B8
    ("int8_matmul (ours)", re.compile(r"gemm_sm90_kernel(<|ILb)(false|0)")),
    ("fp8_matmul (ours)", re.compile(r"gemm_sm90_kernel(<|ILb)(true|1)")),
    ("halo_conv3d (ours)", re.compile(r"halo_conv_sm90_kernel")),
    # the W8A8 conv's activation quantization (csrc/halo_conv.cu), before the
    # cuDNN pattern: its mangled names hold the source's name
    ("quantize_conv_act (ours)", re.compile(r"absmax_kernel|codes_kernel")),
    ("conv (cuDNN)", re.compile(r"conv|fprop|implicit", re.I)),
    ("quantize_rows_int8 (ours)", re.compile(r"quant_rows_kernel")),
    ("ln_modulate_quant (ours)", re.compile(r"ln_quant_kernel")),
    ("gemm (cuBLAS)", re.compile(r"gemm|nvjet|cutlass|xmma|sm90_|cublas", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
    ("softmax/reduce", re.compile(r"softmax|reduce|logsumexp", re.I)),
    ("copy/cat/layout", re.compile(r"copy|cat|transpose|permute|index|fill", re.I)),
)


def group_of(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def traced(run):
    """Run `run()` under torch.profiler; returns (wall ms, device kernel
    events)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    return wall_ms, kernels


def report(title: str, wall_ms: float, kernels, smi: str, extra: dict) -> None:
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    by_group = collections.defaultdict(float)
    for name, us in by_name.items():
        by_group[group_of(name)] += us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    total = sum(by_name.values())
    print(f"{title}, wall {wall_ms:.3f} ms", flush=True)
    print(f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms kernel span: "
          f"idle share {1 - busy / span:.4f} (of the wall time: "
          f"{1 - busy / 1e3 / wall_ms:.4f})", flush=True)
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {label:32s} {us / 1e3:10.3f} ms  {us / total:7.2%}", flush=True)
    print("top kernels:", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:10.3f} ms  {us / total:7.2%}  {name[:110]}", flush=True)
    print(smi, flush=True)
    print(json.dumps({
        **extra, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
        "kernel_span_ms": span / 1e3, "idle_share_of_span": 1 - busy / span,
        "groups_ms": {k: v / 1e3 for k, v in by_group.items()},
        "device": torch.cuda.get_device_name(0)}), flush=True)


def trace_block(dev, smi: str, block: int, path: str) -> None:
    cfg = (fp8w_config(block + 1) if path == "fp8" else
           main_path_config(block + 1, w8a8=path == "w8a8"))
    gen, xattn, noise, g = main_path_setup(dev, cfg)  # chip_smoke.py's main path
    cache = gen.init_cache()
    fpb = cfg.model.num_frame_per_block
    for bi in range(block):
        gen.denoise_block(cache, xattn, noise[:, bi * fpb:(bi + 1) * fpb], bi * fpb,
                          generator=g)
    blk = noise[:, block * fpb:]
    torch.cuda.synchronize()
    launches0 = flash_attention_prefix.launches
    wall_ms, kernels = traced(
        lambda: gen.denoise_block(cache, xattn, blk, block * fpb, generator=g))
    launches = flash_attention_prefix.launches - launches0
    live = (block + 1) * fpb * gen.frame_seq
    report(f"{path} block {block}: 5 forwards over a live "
           f"cache of {live} tokens, kernel launches of ours {launches}",
           wall_ms, kernels, smi,
           {"path": path, "block": block, "live_tokens": live,
            "flash_launches": launches})


def trace_decode(dev, smi: str, conv_impl: str) -> None:
    cfg = VAEConfig()
    vae = CausalVAE(cfg, vae_params(dev, cfg), dtype=torch.bfloat16, device=dev,
                    conv_impl=conv_impl)
    g = torch.Generator(device=dev).manual_seed(6)
    z = torch.randn(1, 6, 60, 104, cfg.z_dim, generator=g, device=dev).to(torch.bfloat16)
    _, cache = vae.decode_chunk(z[:, :3], None, first=True)
    torch.cuda.synchronize()
    wall_ms, kernels = traced(lambda: vae.decode_chunk(z[:, 3:], cache, first=False))
    report(f"VAE decode, conv_impl {conv_impl}: the second 3-latent-frame chunk "
           "(12 pixel frames at 480x832)", wall_ms, kernels, smi,
           {"path": f"vae_{conv_impl}"})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--block", type=int, default=6, help="block to trace, 0..6")
    ap.add_argument("--w8a8", action="store_true", help="trace the W8A8 path")
    ap.add_argument("--fp8", action="store_true", help="trace the fp8 weight-only path")
    ap.add_argument("--vae", choices=CONV_IMPLS,
                    help="trace a VAE decode chunk with this conv impl instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_op_breakdown: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.vae:
        trace_decode(dev, smi, args.vae)
    else:
        trace_block(dev, smi, args.block,
                    "fp8" if args.fp8 else "w8a8" if args.w8a8 else "bf16")


if __name__ == "__main__":
    main()
