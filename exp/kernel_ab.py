#!/usr/bin/env python3
"""In-turn A/B of the int8-KV flash kernel (B2) and the fp8 weight-only GEMM
(B8) against the same kernels of a parent checkout, on one card.

    python3 exp/kernel_ab.py --parent DIR [--turns N]

DIR holds a parent commit's files (`git archive <commit> | tar -x -C DIR`,
into a directory that .gitignore lists). The parent's
`inferix_tpu_torch/csrc/flash_attention_prefix.cu` (its int8-KV entry
`inferix_flash_attention_prefix_quant`) and `csrc/fp8_matmul.cu` are built
with nvcc into DIR/_ab_build and called through ctypes; this checkout's
kernels are called through their wrappers. Each shape is timed parent, this,
this, parent (`--turns` times), with chip_smoke.time_ms (CUDA events, each
call behind a device sleep), and the outputs of both are compared. Shapes:
B2 at spans 4680, 14040 and 32760 keys for 4680 q rows, B=1 and B=2; B8 at
one layer's six GEMMs (M = 4680) and the text K/V (M = 512). Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
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

_OLD_FA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 18
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def build_parent(parent: pathlib.Path) -> dict:
    """The parent's two libraries, built side by side."""
    out = parent / "_ab_build"
    out.mkdir(exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for name in ("flash_attention_prefix", "fp8_matmul"):
        so = out / f"lib{name}.so"
        src = parent / "inferix_tpu_torch" / "csrc" / f"{name}.cu"
        jobs[name] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    fa = libs["flash_attention_prefix"].inferix_flash_attention_prefix_quant
    fa.argtypes, fa.restype = _OLD_FA_ARGTYPES, ctypes.c_int
    fp = libs["fp8_matmul"].inferix_fp8_matmul
    fp.argtypes, fp.restype = tk._FP8_ARGTYPES, ctypes.c_int
    return {"b2": fa, "b8": fp}


def in_turns(old, new, turns: int):
    """(old times, new times) in ms, timed old, new, new, old, `turns` times."""
    times = {old: [], new: []}
    for _ in range(turns):
        for fn in (old, new, new, old):
            times[fn].append(cs.time_ms(fn))
    return times[old], times[new]


def fmt(ts) -> str:
    return " ".join(f"{t:.4f}" for t in ts)


def ab_b2(dev, old_fa, turns: int) -> None:
    g = torch.Generator(device=dev).manual_seed(3)
    b_max = 2
    q = torch.randn(b_max, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kb = torch.randn(b_max, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(kb)
    vq, vs = quantize_kv_block(kb.flip(1))
    del kb
    stream = torch.cuda.current_stream().cuda_stream
    for b in (1, 2):
        for span in (cs.SQ, 3 * cs.SQ, cs.SKV):
            bounds = tfa._bounds_tensor(0, span, b, dev)
            out_old = torch.empty_like(q[:b])

            def old():
                err = old_fa(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                             vs.data_ptr(), out_old.data_ptr(), None, bounds.data_ptr(),
                             b, cs.H, cs.SQ, cs.SKV, *q.stride()[:3], *kq.stride()[:3],
                             *vq.stride()[:3], *ks.stride(), *vs.stride(),
                             *out_old.stride()[:3], cs.D ** -0.5 * tfa.LOG2E, 0, stream)
                if err:
                    raise RuntimeError(f"parent B2 launch failed: CUDA error {err}")

            def new():
                return tfa.flash_attention_prefix_quant(q[:b], kq[:b], vq[:b], ks[:b],
                                                        vs[:b], span)

            old()
            diff = (new().float() - out_old.float()).abs().max().item()
            t_old, t_new = in_turns(old, new, turns)
            bnd, by = cs.attention_bound(b, cs.SQ, span)
            print(f"B2 B={b} span={span}: parent {fmt(t_old)} ms, this {fmt(t_new)} ms, "
                  f"bound {bnd:.4f} ({by}), max |out diff| {diff:.3e}", flush=True)


def ab_b8(dev, old_fp, turns: int) -> None:
    g = torch.Generator(device=dev).manual_seed(6)
    stream = torch.cuda.current_stream().cuda_stream
    layer_old = layer_new = 0.0
    for nm, m, k, n, calls in cs.LAYER_GEMMS + (("text_kv", cs.TEXT, cs.DIM, cs.DIM, 0),):
        x, w_q, ws, bias = cs.fp8_operands(dev, g, m, k, n)
        out_old = torch.empty(m, n, dtype=torch.bfloat16, device=dev)

        def old():
            err = old_fp(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(), 1, bias.data_ptr(),
                         out_old.data_ptr(), m, n, k, 0, stream)
            if err:
                raise RuntimeError(f"parent B8 launch failed: CUDA error {err}")

        def new():
            return tk.fp8_matmul(x, w_q, ws, bias=bias)

        old()
        diff = (new().float() - out_old.float()).abs().max().item()
        t_old, t_new = in_turns(old, new, turns)
        layer_old += calls * min(t_old)
        layer_new += calls * min(t_new)
        print(f"B8 {nm} [{m}x{k}]x[{k}x{n}] ({calls} a layer): parent {fmt(t_old)} ms, "
              f"this {fmt(t_new)} ms, max |out diff| {diff:.3e}", flush=True)
    print(f"B8 one layer (6 GEMMs at M={cs.SQ}, min of turns): parent {layer_old:.4f} ms, "
          f"this {layer_new:.4f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="directory holding the parent commit's files")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, this, this, parent per shape (default 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _build.build(["flash_attention_sm90", "fp8_matmul"])
    old = build_parent(args.parent)
    ab_b2(dev, old["b2"], args.turns)
    ab_b8(dev, old["b8"], args.turns)


if __name__ == "__main__":
    main()
