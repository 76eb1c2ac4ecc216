#!/usr/bin/env python3
"""In-turn A/B of the flash kernels (B1 over bf16 and over e4m3 K/V, B2 over
int8 K/V), of the halo convs (B6 bf16, B7 W8A8), of the quantized GEMMs
(B3 int8, B8 fp8) or of the W8A8 quantization prologues (B4, B5) against a
parent checkout's, on one card.

    python3 exp/kernel_ab.py --parent DIR [--turns N]                 # flash
    python3 exp/kernel_ab.py --kernel halo --parent DIR [--turns N]   # halo conv
    python3 exp/kernel_ab.py --kernel gemm --parent DIR [--turns N]   # GEMMs
    python3 exp/kernel_ab.py --kernel act_quant --parent DIR [--turns N]
    python3 exp/kernel_ab.py --kernel qattn --parent DIR [--turns N]

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
keys, B=1 for B1's two kinds, B=1 and B=2 for B2. (The flash mode needs a
parent that still has `flash_attention_prefix.cu`, such as commit 7c5d2e7.)

--kernel halo: the parent's `csrc/halo_conv.cu` (entry `inferix_halo_conv3d`
with the signature x, w, bias, sv, out, Tout, H, W, Cin, Cout, kt, cin_pad,
bn, int8, stream: the `mma.sync` kernel, up to commit b99fa12) is built the same
way and called on its own operand, w [Cout, kt, 9, Cin padded to 32], with
its wrapper's Cout tile (the widest of 64, 32, 16 dividing Cout) and, for
W8A8, its wrapper's float32 quantization (the torch chain `_quantize_conv_act`
and s_x * s_w); this checkout's side is `halo_conv3d` /
`halo_conv3d_w8a8` on `pack_weight`'s operand (the W8A8 one through the
quantization kernel). Both sides include their quantization, as a decode
calls them. Classes: the seven of PERF.md's B6/B7 table (res 96, res 192,
res 384 at 120x208 and 60x104, the two largest upsample convs (W8A8 only)
and the head), in bf16 (3x3x3 only) and W8A8.

--kernel gemm: the parent's `csrc/int8_matmul.cu` (entry
`inferix_int8_matmul`, the `mma.sync` kernel) and `csrc/fp8_matmul.cu`
(entry `inferix_fp8_matmul`, the non-persistent wgmma kernel), up to commit
4605ebf, are built the same way and called with the signatures this
checkout's `csrc/gemm_sm90.cu` keeps; this checkout's side is
`int8_matmul` / `fp8_matmul`. Shapes: one layer's four (qkv, o, fc1, fc2)
at M = 4680 and at M = 9360 (W8A8 + int8 KV at B=2), and the text K/V at
M = 512, on the main path's operand statistics. The int8 outputs must be
bit-equal (both sum exactly); for fp8 the max |difference| is printed. Per
shape: both sides' times, the bound and the rates; then each side's
per-layer sum at M = 4680 (o x 3) beside the bound.

--kernel act_quant: the parent's `csrc/act_quant.cu` (entries
`inferix_quantize_rows_int8` (x, q, s, M, K, act, stream) and
`inferix_ln_quantize_rows_int8` (x, q, s, p0, p1, batch and frame strides,
M, C, rows per batch, frame_seq, eps, mode, stream): one CTA a row, up to
commit 746cf59) is built the same way; this checkout's side is
`quantize_rows_int8` / `adaln_quantize_rows_int8` / `ln_quantize_rows_int8`.
Shapes: every call of the W8A8 path at M = 4680 and 9360 (o / cross-o
inputs [M x 1536], the fc2 input with gelu [M x 8960], LN + modulate over 3
frames, LN + affine [M x 1536]), the other acts at M 4680 (gelu_exact,
silu_mul over [gate | up] of 2 x 8960), and the int8 K/V writes (B=2:
112320 x 128, the window: 56160 x 128). B4's codes and scales must be
bit-equal to the parent's; for B5 the share of codes that differ is
printed. Per shape: both sides' times, the bound (bytes) and the share of
its rate; then each side's per-layer sums at M 4680 (B4: o, cross-o, fc2;
B5: two LN + modulate, one LN + affine).

--kernel qattn: the parent's `csrc/flash_attention_quant_ext.cu` (entry
`inferix_flash_attention_quant_ext`: the `mma.sync` int8-PV kernels, up to
commit 109923c) is built the same way and called as its wrapper called it
(i8: q quantized per (token, head) by `quantize_q_int8` first, timed with
it); this checkout's side is `flash_attention_prefix_quant_i8` /
`_v2`, its operand pre-pass included. Shapes: B=1 at spans 4680, 14040 and
32760 and B=2 at 32760 (kv group 2048), both modes. The outputs differ
where a code sits at a rounding tie; the max |difference| is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from inferix_tpu_torch import _build  # noqa: E402
from inferix_tpu_torch.kvcache.cache import quantize_kv_block  # noqa: E402
from inferix_tpu_torch.ops import act_quant as taq  # noqa: E402
from inferix_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from inferix_tpu_torch.ops import halo_conv as thc  # noqa: E402
from inferix_tpu_torch.quant import kernels as tk  # noqa: E402

_STRIDES = [ctypes.c_longlong] * 3
# the parent's entry points: (library, symbol, argtypes)
PARENT = {
    "b1": ("flash_attention_prefix", "inferix_flash_attention_prefix",
           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + _STRIDES * 4
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "b2": ("flash_attention_sm90", "inferix_flash_attention_sm90",
           [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _STRIDES * 6
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "halo": ("halo_conv", "inferix_halo_conv3d",
             [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "int8": ("int8_matmul", "inferix_int8_matmul", tk._ARGTYPES),
    "fp8": ("fp8_matmul", "inferix_fp8_matmul", tk._FP8_ARGTYPES),
    "act_quant": ("act_quant", "inferix_quantize_rows_int8",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "qattn": ("flash_attention_quant_ext", "inferix_flash_attention_quant_ext",
              [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + _STRIDES * 5
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}
PARENT_LN = ("inferix_ln_quantize_rows_int8",
             [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
HALO_CLASSES = ("res 96 480x832", "res 192 240x416", "res 384 120x208", "res 384 60x104",
                "up 192->96 480x832", "up 384->192 240x416", "head 96->3 480x832")


def build_parent(parent: pathlib.Path, keys=("b1", "b2")) -> dict:
    """The parent's libraries for `keys`, built side by side."""
    out = parent / "_ab_build"
    out.mkdir(exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for key in keys:
        lib = PARENT[key][0]
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


def halo_ab(dev, parent_fn, turns: int) -> None:
    """B6 and B7 (each with its quantization) against the parent's at the
    seven classes."""
    g = torch.Generator(device=dev).manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    for cname in HALO_CLASSES:
        _, tin, h, w, cin, cout, kt, _, _ = next(c for c in cs.VAE_CONVS if c[0] == cname)
        t_out = tin - kt + 1
        x = torch.randn(tin, h, w, cin, generator=g, device=dev).to(torch.bfloat16)
        wt = ((torch.rand(kt, 3, 3, cin, cout, generator=g, device=dev) * 2 - 1)
              * (kt * 9 * cin) ** -0.5).to(torch.bfloat16)
        b = ((torch.rand(cout, generator=g, device=dev) * 2 - 1)
             * (kt * 9 * cin) ** -0.5).to(torch.bfloat16)
        bias = b.float()
        bn = next((n for n in (64, 32, 16) if cout % n == 0), 16)
        for int8 in (False, True):
            if not int8 and kt != 3:
                continue  # the bf16 gate takes 3x3x3 convs only
            w_el, s_w = thc.quantize_conv_weight(wt) if int8 else (wt, None)
            wk_old = torch.nn.functional.pad(
                w_el.permute(4, 0, 1, 2, 3).reshape(cout, kt, 9, cin), (0, -cin % 32)).contiguous()
            pk = thc.pack_weight(wt, w8a8=int8)
            out_old = torch.empty(t_out, h, w, cout, dtype=torch.bfloat16, device=dev)

            def old():
                xk, sv = x, None
                if int8:
                    xk, s_x = thc._quantize_conv_act(x)
                    sv = (s_x * s_w).contiguous()
                err = parent_fn(xk.data_ptr(), wk_old.data_ptr(), bias.data_ptr(),
                                sv.data_ptr() if int8 else None, out_old.data_ptr(), t_out, h,
                                w, cin, cout, kt, wk_old.shape[-1], bn, int(int8), stream)
                if err:
                    raise RuntimeError(f"parent halo launch failed: CUDA error {err}")

            def new():
                kern = thc.halo_conv3d_w8a8 if int8 else thc.halo_conv3d
                return kern(x, wt, b, packed=pk)
            old()
            diff = (new().float() - out_old.float()).abs().max().item()
            t_old, t_new = in_turns(old, new, turns)
            print(f"{'B7 W8A8' if int8 else 'B6 bf16'} {cname}: parent {fmt(t_old)} ms, this "
                  f"{fmt(t_new)} ms, max |out diff| {diff:.3e}", flush=True)


GEMM_SHAPES = ([(nm, m, k, n, calls) for nm, m, k, n, calls in cs.LAYER_GEMMS]
               + [("text_kv", cs.TEXT, cs.DIM, cs.DIM, 0)]
               + [(nm + " B=2", 2 * m, k, n, 0) for nm, m, k, n, _ in cs.LAYER_GEMMS])


def gemm_ab(dev, parent, turns: int) -> None:
    """B3 and B8 against the parent's kernels at GEMM_SHAPES."""
    g = torch.Generator(device=dev).manual_seed(5)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    layer = {(kind, side): 0.0 for kind in ("int8", "fp8") for side in ("parent", "this")}
    for nm, m, k, n, calls in GEMM_SHAPES:
        xq, wq, xs, ws8, b8 = cs.path_gemm_operands(dev, g, m, k, n)
        x, w8, ws, b = cs.fp8_operands(dev, g, m, k, n)
        out_old = torch.empty(m, n, dtype=torch.bfloat16, device=dev)

        def old_int8():
            err = parent["int8"](xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), 1, ws8.data_ptr(),
                                 1, b8.data_ptr(), out_old.data_ptr(), m, n, k, 0, stream())
            if err:
                raise RuntimeError(f"parent int8 GEMM launch failed: CUDA error {err}")

        def old_fp8():
            err = parent["fp8"](x.data_ptr(), w8.data_ptr(), ws.data_ptr(), 1, b.data_ptr(),
                                out_old.data_ptr(), m, n, k, 0, stream())
            if err:
                raise RuntimeError(f"parent fp8 GEMM launch failed: CUDA error {err}")

        sides = {"int8": (old_int8, lambda: tk.int8_matmul(xq, wq, xs, ws8, bias=b8),
                          cs.gemm_times(m, k, n)),
                 "fp8": (old_fp8, lambda: tk.fp8_matmul(x, w8, ws, bias=b),
                         cs.fp8_gemm_times(m, k, n))}
        for kind, (old, new, (ops_ms, bytes_ms)) in sides.items():
            old()
            out_new = new()
            diff = (out_new.float() - out_old.float()).abs().max().item()
            if kind == "int8" and diff != 0:
                raise AssertionError(f"int8 {nm}: the two kernels differ by {diff}")
            t_old, t_new = in_turns(old, new, turns)
            bound, by = cs.bound_of(ops_ms, bytes_ms)
            mo, mn = statistics.median(t_old), statistics.median(t_new)
            layer[(kind, "parent")] += calls * mo
            layer[(kind, "this")] += calls * mn
            print(f"gemm {kind} {nm} [{m}x{k}]x[{k}x{n}] ({calls} a layer): parent "
                  f"{fmt(t_old)} ms ({cs.gemm_rate(kind, m, k, n, mo, bound)}), this "
                  f"{fmt(t_new)} ms ({cs.gemm_rate(kind, m, k, n, mn, bound)}), bound "
                  f"{bound:.4f} ({by}), max |out diff| {diff:.3e}", flush=True)
    for kind in ("int8", "fp8"):
        print(f"gemm {kind} per layer (M {cs.SQ}, medians): parent "
              f"{layer[(kind, 'parent')]:.4f} ms, this {layer[(kind, 'this')]:.4f} ms",
              flush=True)


def act_quant_ab(dev, parent: pathlib.Path, quant_fn, turns: int) -> None:
    """B4 and B5 against the parent's kernels at the W8A8 path's shapes."""
    ln_fn = getattr(ctypes.CDLL(str(parent / "_ab_build" / "libact_quant.so")), PARENT_LN[0])
    ln_fn.argtypes, ln_fn.restype = PARENT_LN[1], ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(6)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    layer = {(kind, side): 0.0 for kind in ("B4", "B5") for side in ("parent", "this")}

    def report(kind, label, calls, old, new, bound, exact):
        q_old, s_old = old()
        q_new, s_new = new()
        torch.cuda.synchronize()
        dmax, share, events, srel, _ = cs.code_diff((q_new, s_new), (q_old, s_old))
        if exact and (dmax or srel):
            raise AssertionError(f"{kind} {label}: codes or scales differ from the parent's "
                                 f"(max |code diff| {dmax}, scale rel diff {srel:.3e})")
        t_old, t_new = in_turns(old, new, turns)
        mo, mn = statistics.median(t_old), statistics.median(t_new)
        layer[(kind, "parent")] += calls * mo
        layer[(kind, "this")] += calls * mn
        same = "codes and scales =" if not (dmax or srel) else (
            f"codes that differ {share:.3e} (max |diff| {dmax}), rounding events "
            f"{events:.3e}, max scale rel diff {srel:.3e}")
        print(f"{kind} {label} ({calls} a layer): parent {fmt(t_old)} ms "
              f"({cs.quant_rate(mo, bound)}), this {fmt(t_new)} ms ({cs.quant_rate(mn, bound)}), "
              f"bound {bound:.4f} (bytes), {same}", flush=True)

    for m in (cs.SQ, 2 * cs.SQ):
        for nm, k, act, calls in (("o/cross_o", cs.DIM, None, 2), ("fc2_in", cs.FFN, "gelu", 1),
                                  ("gelu_exact", cs.FFN, "gelu_exact", 0),
                                  ("silu_mul", 2 * cs.FFN, "silu_mul", 0)):
            if m > cs.SQ and calls == 0:
                continue
            x = (torch.randn(m, k, generator=g, device=dev) * 2).to(torch.bfloat16)
            k_out = k // 2 if act == "silu_mul" else k

            def old(x=x, k=k, k_out=k_out, act=act):
                q = torch.empty(x.shape[0], k_out, dtype=torch.int8, device=dev)
                s = torch.empty(x.shape[0], 1, device=dev)
                err = quant_fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), x.shape[0], k,
                               taq._ACT_CODE[act], stream())
                if err:
                    raise RuntimeError(f"parent act-quant launch failed: CUDA error {err}")
                return q, s
            report("B4", f"{nm} [{m}x{k}] act {act}", calls if m == cs.SQ else 0, old,
                   lambda x=x, act=act: taq.quantize_rows_int8(x, act=act),
                   cs.quant_bound(m, k, k_out), True)
        b = m // cs.SQ
        x = (torch.randn(b, cs.SQ, cs.DIM, generator=g, device=dev) * 3).to(torch.bfloat16)
        mod = torch.randn(b, 3, 6, cs.DIM, generator=g, device=dev) * 0.5
        w = (1 + 0.1 * torch.randn(cs.DIM, generator=g, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(cs.DIM, generator=g, device=dev)).to(torch.bfloat16)
        for nm, calls, p0, p1, mode, extra in (
                ("adaln qkv/fc1", 2, mod[:, :, 0], mod[:, :, 1], 2, 2 * b * 3 * cs.DIM * 4),
                ("ln affine cross_q", 1, w, bias, 1, 2 * cs.DIM * 2)):
            sb, sf = p0.stride()[:2] if mode == 2 else (0, 0)
            rows_per_batch, frame_seq = (cs.SQ, cs.SQ // 3) if mode == 2 else (m, m)

            def old(x=x, p0=p0, p1=p1, mode=mode, sb=sb, sf=sf, rpb=rows_per_batch,
                    fs=frame_seq):
                q = torch.empty(m, cs.DIM, dtype=torch.int8, device=dev)
                s = torch.empty(m, 1, device=dev)
                err = ln_fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), p0.data_ptr(),
                            p1.data_ptr(), sb, sf, m, cs.DIM, rpb, fs, 1e-6, mode, stream())
                if err:
                    raise RuntimeError(f"parent LN launch failed: CUDA error {err}")
                return q, s

            def new(x=x, p0=p0, p1=p1, mode=mode):
                if mode == 2:
                    q, s = taq.adaln_quantize_rows_int8(x, p0, p1)
                else:
                    q, s = taq.ln_quantize_rows_int8(x.reshape(-1, cs.DIM), p0, p1)
                return q.reshape(m, cs.DIM), s.reshape(m, 1)
            report("B5", f"{nm} [{m}x{cs.DIM}]", calls if m == cs.SQ else 0, old, new,
                   cs.quant_bound(m, cs.DIM, cs.DIM, extra), False)
    x = torch.randn(2 * cs.SQ * cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    for nm, rows in (("kv_write_b2", 2 * cs.SQ * cs.H), ("kv_write_window", cs.SQ * cs.H)):
        xr = x[:rows]

        def old(xr=xr):
            q = torch.empty(xr.shape, dtype=torch.int8, device=dev)
            s = torch.empty(xr.shape[0], 1, device=dev)
            err = quant_fn(xr.data_ptr(), q.data_ptr(), s.data_ptr(), xr.shape[0], cs.D, 0,
                           stream())
            if err:
                raise RuntimeError(f"parent act-quant launch failed: CUDA error {err}")
            return q, s
        report("B4", f"{nm} [{rows}x{cs.D}] act None", 0, old,
               lambda xr=xr: taq.quantize_rows_int8(xr), cs.quant_bound(rows, cs.D, cs.D), True)
    for kind in ("B4", "B5"):
        print(f"{kind} per layer (M {cs.SQ}, medians): parent {layer[(kind, 'parent')]:.4f} ms, "
              f"this {layer[(kind, 'this')]:.4f} ms", flush=True)


def qattn_ab(dev, parent_fn, turns: int) -> None:
    """B9 and B10 against the parent's mma.sync kernel: both whole wrapper
    calls (the parent's quantizes q for i8 in torch; this one runs its
    operand pre-pass), B=1 at the three spans and B=2 at the full cache."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(2, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(torch.randn(2, cs.SKV, cs.H, cs.D, generator=g, device=dev)
                               .to(torch.bfloat16))
    vq, vs = quantize_kv_block(torch.randn(2, cs.SKV, cs.H, cs.D, generator=g, device=dev)
                               .to(torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    scale = cs.D ** -0.5
    for mode, kern in (("i8", tfa.flash_attention_prefix_quant_i8),
                       ("v2", tfa.flash_attention_prefix_quant_v2)):
        for b, span in [(1, s) for s in cs.SPANS] + [(2, cs.SKV)]:
            lens = torch.full((b,), span, dtype=torch.int32, device=dev)
            out_old = torch.empty_like(q[:b])
            args = (q[:b], kq[:b], vq[:b], ks[:b], vs[:b])

            def old():
                if mode == "i8":
                    qk, qs = tfa.quantize_q_int8(q[:b], scale)
                else:
                    qk, qs = q[:b], None
                err = parent_fn(qk.data_ptr(), qs.data_ptr() if qs is not None else None,
                                kq.data_ptr(), vq.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                                out_old.data_ptr(), None, lens.data_ptr(), None, b, cs.H,
                                cs.SQ, cs.SKV, 2048, *qk.stride()[:3], *kq.stride()[:3],
                                *vq.stride()[:3], *ks.stride(), *vs.stride(),
                                scale * tfa.LOG2E, int(mode == "v2"), stream)
                if err:
                    raise RuntimeError(f"parent {mode} launch failed: CUDA error {err}")

            def new():
                return kern(*args, span)

            old()
            diff = (new().float() - out_old.float()).abs().max().item()
            t_old, t_new = in_turns(old, new, turns)
            bnd, by = cs.quant_attention_bound(mode, b, span)
            print(f"qattn {mode} B={b} span={span}: parent {fmt(t_old)} ms, this "
                  f"{fmt(t_new)} ms, bound {bnd:.4f} ({by}), max |out diff| {diff:.3e}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="directory holding the parent commit's files")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, this, this, parent per shape (default 1)")
    ap.add_argument("--kernel", choices=("flash", "halo", "gemm", "act_quant", "qattn"),
                    default="flash",
                    help="which kernels to compare (default flash)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    if args.kernel == "gemm":
        _build.build([tk.GEMM_LIBRARY])
        gemm_ab(dev, build_parent(args.parent, ("int8", "fp8")), args.turns)
        return
    if args.kernel == "act_quant":
        _build.build(["act_quant"])
        act_quant_ab(dev, args.parent, build_parent(args.parent, ("act_quant",))["act_quant"],
                     args.turns)
        return
    if args.kernel == "qattn":
        _build.build(["flash_attention_sm90"])
        qattn_ab(dev, build_parent(args.parent, ("qattn",))["qattn"], args.turns)
        return
    if args.kernel == "halo":
        _build.build(["halo_conv"])
        halo_ab(dev, build_parent(args.parent, ("halo",))["halo"], args.turns)
        return
    _build.build(["flash_attention_sm90"])
    ab(dev, build_parent(args.parent), args.turns)


if __name__ == "__main__":
    main()
