#!/usr/bin/env python3
"""In-turn A/B of the flash kernels against a parent checkout's, on one card:
B1 over bf16 and over e4m3 K/V, and B2 over int8 K/V.

    python3 exp/kernel_ab.py --parent DIR [--turns N]

DIR holds a parent commit's files (`git archive <commit> | tar -x -C DIR`,
into a directory that .gitignore lists). The parent's
`inferix_tpu_torch/csrc/flash_attention_prefix.cu` (B1, entry
`inferix_flash_attention_prefix`, `mma.sync`) and `csrc/flash_attention_sm90.cu`
(B2, entry `inferix_flash_attention_sm90`) are built with nvcc into
DIR/_ab_build and called through ctypes with the parent's signatures; this
checkout's kernel is called through its wrappers. Each shape is timed
parent, this, this, parent (`--turns` times), with chip_smoke.time_ms (CUDA
events, each call behind a device sleep), and the outputs of both are
compared (max |difference|; the summation order differs, so they need not
be bit-equal). Shapes: 4680 q rows over spans of 4680, 14040 and 32760
keys, B=1 for B1's two kinds, B=1 and B=2 for B2. Prints the card's name
and power limit first.
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

_STRIDES = [ctypes.c_longlong] * 3
# the parent's entry points: (library, symbol, argtypes)
PARENT = {
    "b1": ("flash_attention_prefix", "inferix_flash_attention_prefix",
           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + _STRIDES * 4
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "b2": ("flash_attention_sm90", "inferix_flash_attention_sm90",
           [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _STRIDES * 6
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


def build_parent(parent: pathlib.Path) -> dict:
    """The parent's two flash libraries, built side by side."""
    out = parent / "_ab_build"
    out.mkdir(exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for key, (lib, _, _) in PARENT.items():
        so = out / f"lib{lib}.so"
        src = parent / "inferix_tpu_torch" / "csrc" / f"{lib}.cu"
        jobs[key] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    fns = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {PARENT[key][0]}.cu:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), PARENT[key][1])
        fn.argtypes, fn.restype = PARENT[key][2], ctypes.c_int
        fns[key] = fn
    return fns


def in_turns(old, new, turns: int):
    """(old times, new times) in ms, timed old, new, new, old, `turns` times."""
    times = {old: [], new: []}
    for _ in range(turns):
        for fn in (old, new, new, old):
            times[fn].append(cs.time_ms(fn))
    return times[old], times[new]


def fmt(ts) -> str:
    return " ".join(f"{t:.4f}" for t in ts)


def compare(label, b, span, old, new, out_old, turns) -> None:
    old()
    diff = (new().float() - out_old.float()).abs().max().item()
    t_old, t_new = in_turns(old, new, turns)
    bnd, by = cs.attention_bound(b, cs.SQ, span)
    print(f"{label} B={b} span={span}: parent {fmt(t_old)} ms, this {fmt(t_new)} ms, "
          f"bound {bnd:.4f} ({by}), max |out diff| {diff:.3e}", flush=True)


def ab(dev, parent, turns: int) -> None:
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(2, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_kv_block(k), quantize_kv_block(v)
    k8, v8 = (x.float().clamp(-448, 448).to(tfa.FP8) for x in (k, v))
    stream = torch.cuda.current_stream().cuda_stream
    scale = cs.D ** -0.5 * tfa.LOG2E
    for kind, kk, vv in (("bf16", k, v), ("e4m3", k8, v8)):
        code = tfa._KV_KIND[kk.dtype]
        for span in cs.SPANS:
            bounds = tfa._bounds_tensor(0, span, 1, dev)
            out_old = torch.empty_like(q[:1])

            def old():
                err = parent["b1"](q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                   out_old.data_ptr(), None, bounds.data_ptr(), 1, cs.H,
                                   cs.SQ, cs.SKV, *q.stride()[:3], *kk.stride()[:3],
                                   *vv.stride()[:3], *out_old.stride()[:3], scale, 0, code,
                                   stream)
                if err:
                    raise RuntimeError(f"parent B1 launch failed: CUDA error {err}")

            def new():
                return tfa.flash_attention_prefix(q[:1], kk[:1], vv[:1], span)

            compare(f"B1 {kind}", 1, span, old, new, out_old, turns)
    for b in (1, 2):
        for span in cs.SPANS:
            bounds = tfa._bounds_tensor(0, span, b, dev)
            out_old = torch.empty_like(q[:b])

            def old():
                err = parent["b2"](q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                                   vs.data_ptr(), out_old.data_ptr(), None, bounds.data_ptr(),
                                   b, cs.H, cs.SQ, cs.SKV, *q.stride()[:3], *kq.stride()[:3],
                                   *vq.stride()[:3], *ks.stride(), *vs.stride(),
                                   *out_old.stride()[:3], scale, 0, 2, stream)
                if err:
                    raise RuntimeError(f"parent B2 launch failed: CUDA error {err}")

            def new():
                return tfa.flash_attention_prefix_quant(q[:b], kq[:b], vq[:b], ks[:b],
                                                        vs[:b], span)

            compare("B2 int8", b, span, old, new, out_old, turns)


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
    _build.build(["flash_attention_sm90"])
    ab(dev, build_parent(args.parent), args.turns)


if __name__ == "__main__":
    main()
