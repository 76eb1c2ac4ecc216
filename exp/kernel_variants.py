#!/usr/bin/env python3
"""Where the time of the int8-KV flash kernel (B2) and the fp8 GEMM (B8) goes:
measurement-only variants of their sources, timed against the kernels as
they are, in turns, on one card.

    python3 exp/kernel_variants.py

Each variant is the checked-in source with one piece of work taken out (its
output is wrong; it is compared with the real kernel only to show how much it
moved), built with nvcc into inferix_tpu_torch/_build/variants/ and called
through the real wrapper with its library swapped in:
  B2 (full cache, B=1 and B=2, fixedm): no widening at all, no widening of
     the keys (the producer warpgroup's share), no widening of the values
     (the consumer warpgroups' share), no exp2.
  B8 (one layer's six GEMMs at M = 4680, and the text K/V): e4m3 bytes used
     as bf16 bits (no widening), no output store, 5 ring stages.
Prints the card's name and power limit first, then one line per shape with
the real kernel's times and each variant's, as real, variant, variant, real.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from inferix_tpu_torch import _build  # noqa: E402
from inferix_tpu_torch.kvcache.cache import quantize_kv_block  # noqa: E402
from inferix_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from inferix_tpu_torch.quant import kernels as tk  # noqa: E402

B2_KEYS = ("      for (int jj = 0; jj < 4; ++jj) {\n        const int i = pt + 128 * jj;",
           "      for (int jj = 0; jj < 0; ++jj) {\n        const int i = pt + 128 * jj;")
B2_VALUES = ("      for (int jj = 0; jj < 2; ++jj) {\n        const int i = tid + 256 * jj;",
             "      for (int jj = 0; jj < 0; ++jj) {\n        const int i = tid + 256 * jj;")
VARIANTS = {
    "flash_attention_sm90": {
        "no_widening": [B2_KEYS, B2_VALUES],
        "no_key_widening": [B2_KEYS],
        "no_value_widening": [B2_VALUES],
        "no_exp2": [("        for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i]);",
                     "        for (int i = 0; i < 32; ++i) s[i] = s[i] * 1e-3f;")],
    },
    "fp8_matmul": {
        "no_widening": [("        a[kk][0] = widen2(lo, 0);\n        a[kk][1] = widen2(hi, 0);\n"
                         "        a[kk][2] = widen2(lo, 16);\n        a[kk][3] = widen2(hi, 16);",
                         "        a[kk][0] = lo;\n        a[kk][1] = hi;\n"
                         "        a[kk][2] = lo >> 8;\n        a[kk][3] = hi >> 8;")],
        "no_store": [("      if (gm < p.M && gn < p.N) {", "      if (gm < 0) {")],
        "stages_5": [("constexpr int kStages = 4;", "constexpr int kStages = 5;")],
    },
}
ENTRY = {"flash_attention_sm90": ("inferix_flash_attention_sm90", tfa._ARGTYPES_SM90),
         "fp8_matmul": ("inferix_fp8_matmul", tk._FP8_ARGTYPES)}


def build_variants() -> dict:
    """{(library, variant): ctypes function}, one nvcc per variant, together."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for lib, variants in VARIANTS.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{lib} variant {name}: the source no longer "
                                       f"holds {old!r} once")
                text = text.replace(old, new)
            cu = out / f"{lib}__{name}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            jobs[(lib, name)] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (lib, name), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {lib} variant {name}:\n{log}")
        entry, argtypes = ENTRY[lib]
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(lib, name)] = fn
    return fns


def in_turns(run, install, real, variant) -> tuple:
    """Times (ms) of run() with the real kernel and with the variant
    installed (install(fn) swaps the wrapper's library entry), as real,
    variant, variant, real."""
    times = ([], [])
    for fn in (real, variant, variant, real):
        install(fn)
        times[fn is variant].append(cs.time_ms(run))
    install(real)
    return times


def install_b2(fn) -> None:
    tfa._lib_sm90 = lambda: fn


def install_b8(fn) -> None:
    tk._fp8_kernel = lambda: fn


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    real_b2, real_b8 = tfa._lib_sm90(), tk._fp8_kernel()
    fns = build_variants()
    fmt = lambda ts: " ".join(f"{t:.4f}" for t in ts)  # noqa: E731

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kb = torch.randn(2, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(kb)
    vq, vs = quantize_kv_block(kb.flip(1))
    del kb
    for b in (1, 2):
        def run():
            return tfa.flash_attention_prefix_quant(q[:b], kq[:b], vq[:b], ks[:b], vs[:b],
                                                    cs.SKV)
        for (lib, name), fn in fns.items():
            if lib == "flash_attention_sm90":
                real, var = in_turns(run, install_b2, real_b2, fn)
                print(f"B2 B={b} full cache: kernel {fmt(real)} ms, {name} {fmt(var)} ms",
                      flush=True)
    del q, kq, vq, ks, vs

    g = torch.Generator(device=dev).manual_seed(6)
    for nm, m, k, n, calls in cs.LAYER_GEMMS + (("text_kv", cs.TEXT, cs.DIM, cs.DIM, 0),):
        x, w_q, ws, bias = cs.fp8_operands(dev, g, m, k, n)

        def run():
            return tk.fp8_matmul(x, w_q, ws, bias=bias)
        for (lib, name), fn in fns.items():
            if lib == "fp8_matmul":
                real, var = in_turns(run, install_b8, real_b8, fn)
                print(f"B8 {nm} [{m}x{k}]x[{k}x{n}] ({calls} a layer): kernel {fmt(real)} ms, "
                      f"{name} {fmt(var)} ms", flush=True)


if __name__ == "__main__":
    main()
