#!/usr/bin/env python3
"""Where the time of the flash kernel (`csrc/flash_attention_sm90.cu`: B1 over
bf16 and e4m3 K/V, B2 over int8), of the quantized GEMMs
(`csrc/gemm_sm90.cu`: B3 int8, B8 fp8), of the halo conv
(`csrc/halo_conv.cu`: B6 bf16, B7 int8) and of the quantization prologues
(`csrc/act_quant.cu`: B4, B5) goes: what ptxas made of variants of the
sources, and the variants timed against the shipped kernels, in turns, on
one card.

    python3 exp/kernel_variants.py
    python3 exp/kernel_variants.py --gemm
    python3 exp/kernel_variants.py --halo
    python3 exp/kernel_variants.py --act-quant
    python3 exp/kernel_variants.py --qattn

Each variant is the checked-in source with one piece changed (most give
wrong outputs; they are compared with the real kernel only to show how much
the piece costs), built with nvcc into inferix_tpu_torch/_build/variants/
and called through the real wrapper with its library swapped in.
1. Registers: the flash source and each flash variant compiled with
   `-Xptxas -v`; per instantiation (kind, runmax): ptxas's performance
   warnings (C75xx), spill stores, the highest register the SASS names,
   local loads/stores after the consumers' `setmaxnreg.inc` and after the
   producer's `.dec` (the SASS lays the branches out in that order), and
   the wgmma waits (WARPGROUP.DEPBAR: 4 when none is serialised).
2. Flash variants at the full cache (B=1, 4680 q rows over 32760 keys,
   fixedm), for each kind:
     trap_wait: the mbarrier wait bounded by __trap() instead of a
       faulting store;
     sequential: a warpgroup's QK^T waits for its PV (wait_group 0 where
       the kernel waits for S alone): no intra-warpgroup overlap;
     no_exp2: p = s * 2^-10 instead of exp2(s);
     q_smem: QK^T's A operand (q) read from shared memory by every wgmma
       instead of held in registers;
     no_widening, no_key_widening, no_value_widening (e4m3, int8): the
       producer (keys) and/or the consumers (values) leave the bf16 ring as
       it is;
     widen_copy (e4m3, int8): the widening moves the bytes without
       converting them;
     regs_56_224 (e4m3, int8): the producer at 56 registers (its widening
       unrolled by 4), the consumers at 224.
3. The wave tail: bf16 over 32760 keys at Sq 4224 (33 q tiles x 12 heads =
   396 units, 3 whole rounds on 132 SMs) and 4680 (444 units), each with
   the tail split (`tail_split`) and with every unit whole.
--gemm instead: per instantiation of the GEMM kernel (int8 or fp8; output
f32; tile width) ptxas's performance warnings (C75xx: C7510-C7520 name a
serialised wgmma), spill stores, the highest register, the SASS's wgmma,
wgmma waits (WARPGROUP.DEPBAR) and warpgroup arrives, and the setmaxnreg
pair; then each variant against the
shipped kernel at one layer's four shapes (M 4680), the text K/V (M 512)
and the o shape at M 9360, int8 and fp8, `=` where the output is
bit-equal to the kernel's:
     wait0: every k-stage waits for its own wgmmas (wait_group 0), no group
       in flight across stages;
     tile256: the tile width fixed at 256 (no 224 / 128 plan);
     group1: tiles walked row tile by row tile (no grouped order);
     no_store: the epilogue without its TMA stores (wrong outputs);
     no_epilogue: no epilogue at all (wrong outputs): what it costs;
     ws_const: the per-column scale loads replaced by 1 (wrong outputs);
     one_round: 32 KB of output staging a warpgroup, a tile's boxes in one
       round (no wait for the round before's stores; fewer ring stages);
     stages4: at most 4 ring stages (5 shipped where they fit);
     no_widen: the fp8 A fragments are the gathered e4m3 bytes, unwidened
       (wrong outputs): what the widening costs;
     no_gather: the fp8 A fragments widened from register values instead of
       the raw tile's bytes (wrong outputs): what the gathers cost;
     i2f_magic: int32 -> f32 as two exact halves added once (the same
       rounding as __int2float_rn) instead of the conversion instruction.
--halo instead: per instantiation of the halo conv (int8, N, consumer
warpgroups) ptxas's warnings, spill stores, the highest register, and the
SASS's wgmma (GMMA), wgmma waits (WARPGROUP.DEPBAR) and warpgroup arrives;
then, at the decode's res 96, res 192 and head classes in bf16 and int8,
each variant against the shipped kernel (same inputs; `=` where the output
is bit-equal to the kernel's):
     no_tap_fence: no explicit wgmma.fence a tap (ptxas then injects
       warpgroup arrives, C7519/C7520);
     direct_store: the epilogue stores its fragments straight from registers
       instead of staging an 8 x 8-pixel block in shared memory for a TMA
       store;
     wring3, wring8: 3 or 8 weight tiles in flight (4 shipped);
     base_offset: the shifted A descriptors with the base-offset field set
       to the start's phase in the swizzle pattern (wrong outputs: wgmma
       swizzles on absolute address bits);
     wgs2: the 16-row tile (2 consumer warpgroups) where the plan takes 24.
--act-quant instead: per instantiation of the two row kernels (act or mode,
G, register-resident or two-pass) the registers, stack frame and spill bytes
ptxas reports and the local loads and stores in the SASS (0 expected), and
the SASS's instructions an element by pipe: FP32 (FFMA, FADD, FMUL: 128
lanes a clock an SM on an H100), MUFU and conversions (F2I, I2F, F2F,
F2FP, FRND: 16 a clock an SM, the CUDA programming guide's table for
compute capability 9.0), and all instructions (4 warp instructions issued a
clock an SM: 128 lanes). Counted statically over the function, divided by
the 8 x chunks x rows values a thread holds (so the prologue, the
reductions and the division's slow path add a little). Then, for each call
of the W8A8 path, the instruction bounds at the card's largest SM clock
(`nvidia-smi --query-gpu=clocks.max.sm`) beside the bytes bound: the gelu
fold's accurate tanh may put it above its bytes. Then each variant against
the shipped kernels at the five W8A8 path calls (o / cross-o, the gelu
fold, the int8 K/V write at B=2, LN + modulate, LN + affine; `=` where
the output is bit-equal to the shipped kernel's):
     fdiv: v / scale by __fdiv_rn instead of the reciprocal and two
       corrections (the same quotient);
     f32_modulate: the modulate in f32 operations each rounded to bf16,
       as the first version of the kernel took it (the same values);
     ln_rows4, ln_rows8: 4 or 8 rows a LayerNorm group (2 shipped);
     g16_rows1: one row at a time a G 16 group (2 shipped);
     cta256: 256-thread CTAs for the G 32 class (128 shipped);
     regs64: both kernels held to 64 registers a thread (8 CTAs of 128
       threads an SM).
--qattn instead: the int8-PV attention kernels (B9 i8, B10 v2: the
`flash_quant_sm90_kernel` instantiations of `csrc/flash_attention_sm90.cu`)
and the operand pre-pass: per instantiation ptxas's performance warnings
(C75xx), spill stores, the highest register, the SASS's IGMMA / HGMMA
instructions, wgmma waits and arrives, and the setmaxnreg pair; the
wrapper's pre-pass pieces timed (`quant_operands`, `quant_ext_rows`); then
each variant against the shipped kernel at the full cache (B=1, 4680 q rows
over 32760 keys, kv group 2048), both modes (`=` where the output is
bit-equal to the shipped kernel's, else the max |difference| from the plain
version):
     exp2f: p = exp2f (the plain version's; a p below 2^-126 as a subnormal)
       instead of ex2.approx.ftz;
     no_exp: p = s * 2^-10 (wrong outputs): what the exp2 costs;
     no_pass1_math: pass 1's halves untouched (wrong outputs): what its
       logits and maxima cost;
     no_codes_math: pass 2 without p, l and the codes (wrong outputs);
     gemm_only: both passes' products alone, without logits, maxima, p or
       codes (wrong outputs): the frame's own time;
     no_pv: pass 2 without its PV product (wrong outputs);
     no_pingpong: the consumer warpgroups issue their products whenever
       their stages have landed, not in turns;
     serial: a warpgroup's QK waits for its PV (wait_group 0 where the kernel
       waits for S alone): no intra-warpgroup overlap;
     ks2: 2 K stages (4 for i8, 3 for v2 shipped); vs3: 3 V stages (2).
Prints the card's name and power limit first; times are as real, variant,
variant, real.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
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

FLASH = {
    "trap_wait": [("    if (n == (1u << 22)) asm volatile(", "    if (n == (1u << 22)) __trap();\n"
                   "    if (false) asm volatile(")],
    "sequential": [("        wgmma_wait<1>();  // S of tile j", "        wgmma_wait<0>();  // S of tile j")],
    "no_exp2": [("        for (int i = 0; i < 64; ++i) s[i] = ex2(s[i]);",
                 "        for (int i = 0; i < 64; ++i) s[i] = s[i] * 0.0009765625f;")],
    "no_widening": [("  for (int jj = 0; jj < kRawTile / 16 / kN; ++jj) {",
                     "  for (int jj = 0; jj < 0; ++jj) {")],
    "no_key_widening": [("        widen_tile<kKV, 128>(", "        if (false) widen_tile<kKV, 128>(")],
    "no_value_widening": [("      widen_tile<kKV, 256>(", "      if (false) widen_tile<kKV, 256>(")],
    "widen_copy": [("    const uint2 a = widen4<kKV>(v.x), bb = widen4<kKV>(v.y);\n"
                    "    const uint2 cc = widen4<kKV>(v.z), d = widen4<kKV>(v.w);",
                    "    const uint2 a = make_uint2(v.x, v.y), bb = make_uint2(v.z, v.w);\n"
                    "    const uint2 cc = make_uint2(v.y, v.x), d = make_uint2(v.w, v.z);")],
    "q_smem": [("        wgmma_m64n128k16_rs<0>(s, qa[kk], sw128_desc(ka + (kk >> 2) * kHalf + (kk & 3) * 32),\n"
                "                               kk > 0);",
                "        wgmma_m64n128k16_ss(s, sw128_desc(smem_u32(tiles) + wg * 8192 + (kk >> 2) * 16384 "
                "+ (kk & 3) * 32),\n sw128_desc(ka + (kk >> 2) * kHalf + (kk & 3) * 32), kk > 0);")],
    "regs_56_224": [("  static constexpr int kProducerRegs = 40;\n  static constexpr int kConsumerRegs = 232;",
                     "  static constexpr int kProducerRegs = kByte ? 56 : 40;\n"
                     "  static constexpr int kConsumerRegs = kByte ? 224 : 232;"),
                    ("  constexpr int kUnroll = 2;", "  constexpr int kUnroll = kN == 128 ? 4 : 2;")],
}
HALO = {
    "no_tap_fence": [("          // an explicit fence a tap: without it ptxas injects a warpgroup\n"
                      "          // arrive in a divergent path and serialises every wgmma (C7520)\n"
                      "          wgmma_fence();\n", "")],
    "direct_store": [("  p.tma_store = n_tile == 96 &&", "  p.tma_store = false && n_tile == 96 &&")],
    "wring3": [("kN == 8 ? kMaxWStages : 4;", "kN == 8 ? kMaxWStages : 3;")],
    "wring8": [("kN == 8 ? kMaxWStages : 4;", "kN == 8 ? kMaxWStages : 8;")],
    "base_offset": [("         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);",
                     "         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62) |\n"
                     "         (static_cast<uint64_t>((addr >> 7) & 7) << 49);")],
}
GEMM = {
    "wait0": [("      wgmma_wait<1>();  // the stage before is read: release it",
               "      wgmma_wait<0>();  // the stage before is read: release it")],
    "tile256": [("  for (int bn : {256, 224, 128}) {", "  for (int bn : {256}) {")],
    "group1": [("constexpr int kGroupM = 8; ", "constexpr int kGroupM = 1; ")],
    "no_store": [("              if (b0 + sb < kBoxes && col < p.N && rw < p.M)",
                  "              if (false)"),
                 ("                if (tb0 + t < kTbs && tok < p.M && ch < p.N)",
                  "                if (false)")],
    "no_epilogue": [("      const int rw = r0 + 64 * wg;               // this warpgroup's first row",
                     "      if (tile >= 0) continue;\n      const int rw = r0 + 64 * wg;")],
    "ws_const": [("? __ldg(p.ws + static_cast<long long>(n) * p.ws_stride) : 0.f;",
                  "? 1.f : 0.f;")],
    "one_round": [("constexpr int kOutBytes = 32768; ", "constexpr int kOutBytes = 65536; ")],
    "stages4": [("constexpr int kMaxStages = 5;", "constexpr int kMaxStages = 4;")],
    "no_widen": [("    const uint2 lo = widen4(gather4(tile, row, kk, t4));\n"
                  "    const uint2 hi = widen4(gather4(tile, row + 8, kk, t4));",
                  "    const uint2 lo = make_uint2(gather4(tile, row, kk, t4), 0u);\n"
                  "    const uint2 hi = make_uint2(gather4(tile, row + 8, kk, t4), 0u);")],
    "no_gather": [("  const uint32_t a = *reinterpret_cast<const uint32_t*>(chunk + 4 * (t4 >> 1));\n"
                   "  const uint32_t b = *reinterpret_cast<const uint32_t*>(chunk + 8 + 4 * (t4 >> 1));",
                   "  const uint32_t a = static_cast<uint32_t>(row * 0x01010101);\n"
                   "  const uint32_t b = static_cast<uint32_t>(kk * 0x01010101) ^ a;")],
    "i2f_magic": [("  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);",
                   "  const float hi = __int_as_float(0x53400000 + (acc >> 16)) - 824633720832.0f;\n"
                   "  const float lo = __int_as_float(0x4B400000 + (acc & 0xffff)) - 12582912.0f;\n"
                   "  return __fmul_rn(__fmul_rn(__fadd_rn(hi, lo), xs), ws);")],
}
FP8_ONLY = ("no_widen", "no_gather")
INT8_ONLY = ("i2f_magic",)
VARIANTS = {
    "flash_attention_sm90": FLASH,
    "halo_conv": HALO,
    "gemm_sm90": GEMM,
    "act_quant": {
        "fdiv": [("  float q = __fmul_rn(a, d.y);\n"
                  "  q = __fmaf_rn(__fmaf_rn(-d.b, q, a), d.y, q);\n"
                  "  return __fmaf_rn(__fmaf_rn(-d.b, q, a), d.y, q);",
                  "  return __fdiv_rn(a, d.b);")],
        "f32_modulate": [("  return bf16x2_fma(bf16x2_fma(h, sc, 0x80008000u), 0x3f803f80u, sh);",
                          "  const float h0 = __uint_as_float(h << 16), h1 = __uint_as_float(h & 0xffff0000u);\n"
                          "  const float c0 = __uint_as_float(sc << 16), c1 = __uint_as_float(sc & 0xffff0000u);\n"
                          "  const float b0 = __uint_as_float(sh << 16), b1 = __uint_as_float(sh & 0xffff0000u);\n"
                          "  const __nv_bfloat162 r = __floats2bfloat162_rn(\n"
                          "      __fadd_rn(bf16_round(__fmul_rn(h0, c0)), b0),\n"
                          "      __fadd_rn(bf16_round(__fmul_rn(h1, c1)), b1));\n"
                          "  return *reinterpret_cast<const uint32_t*>(&r);")],
        "ln_rows4": [("constexpr int kLnRows = 2;", "constexpr int kLnRows = 4;")],
        "ln_rows8": [("constexpr int kLnRows = 2;", "constexpr int kLnRows = 8;")],
        "g16_rows1": [("static constexpr int kRows = G == 16 ? 2 : 1;",
                       "static constexpr int kRows = 1;")],
        "cta256": [("static constexpr int kThreads = G == 16 ? 256 : 128;",
                    "static constexpr int kThreads = G == 128 ? 128 : 256;")],
        "regs64": [("__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads)\n"
                    "quant_rows_kernel(",
                    "__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads,\n"
                    "                                  8192 / RowClass<G, kChunks>::kThreads / 8)\n"
                    "quant_rows_kernel("),
                   ("__launch_bounds__(RowClass<G, kChunks>::kThreads) ln_quant_kernel(",
                    "__launch_bounds__(RowClass<G, kChunks>::kThreads,\n"
                    "                  8192 / RowClass<G, kChunks>::kThreads / 8) ln_quant_kernel(")],
    },
}
PASS1_LOOP = """        take(ha, j, 0);
        wgmma_wait<0>();
        take(hb, j, 1);
"""
CODES_LOOP = """        logits(sa, kc + j, 0, g1 - (g0 + j * kBlockN), Flag<true>{},
               __int_as_float(0xff800000));
        const float* vrow = rows + ((kc + j) % KS) * R * kBlockN + kBlockN;
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8) {
"""
EXP2 = "const float pe = ex2(as_f(sa[4 * n8 + e]));"
NO_TAKE = [(PASS1_LOOP, "        wgmma_wait<0>();\n")]
QATTN = {
    "exp2f": [(EXP2, EXP2.replace("ex2(", "exp2f("))],
    "no_exp": [(EXP2, "const float pe = __fmul_rn(as_f(sa[4 * n8 + e]), 0.0009765625f);")],
    "no_pass1_math": NO_TAKE,
    "no_codes_math": [(CODES_LOOP, CODES_LOOP.replace("n8 < 16", "n8 < 0"))],
    "gemm_only": NO_TAKE + [(CODES_LOOP, CODES_LOOP.replace(
        "        logits(sa, kc + j, 0, g1 - (g0 + j * kBlockN), Flag<true>{},\n"
        "               __int_as_float(0xff800000));\n", "").replace(
        "n8 < 16", "n8 < 0"))],
    "no_pv": [("      for (int kk = 0; kk < 4; ++kk) wgmma_s8_rs(oi, pa[kk], sw128_desc(va + kk * 32), 1);",
               "")],
    "no_pingpong": [("    auto turn = [&] { bar_sync(4 + wg, 256); };\n"
                     "    auto pass_turn = [&] { bar_arrive(5 - wg, 256); };\n"
                     "    if (wg == 1) bar_arrive(4, 256);",
                     "    auto turn = [&] {};\n    auto pass_turn = [&] {};")],
    "serial": [("        wgmma_wait<1>();  // this tile's S has landed; the PV of the tile before runs on",
                "        wgmma_wait<0>();")],
    "ks2": [("  static constexpr int kKStages = kI8 ? 4 : 3;", "  static constexpr int kKStages = 2;")],
    "vs3": [("  static constexpr int kVStages = 2;\n  static constexpr int kOBytes",
             "  static constexpr int kVStages = 3;\n  static constexpr int kOBytes")],
}
ENTRY = {"flash_attention_sm90": ("inferix_flash_attention_sm90", tfa._ARGTYPES_SM90)}
KINDS = {0: "bf16", 1: "e4m3", 2: "int8"}
BYTE_ONLY = ("no_widening", "no_key_widening", "no_value_widening", "widen_copy",
             "regs_56_224")  # the widening's variants


def build_variants(libs, table=None) -> dict:
    """{(library, variant): (.so path, nvcc output)}, the flash source as it
    is among them ("shipped"), one nvcc per variant, all started together;
    table: the variants of the one library in libs, in place of VARIANTS'."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for lib in libs:
        src = (_build.CSRC / f"{lib}.cu").read_text()
        variants = dict(VARIANTS[lib] if table is None else table)
        if lib in ("flash_attention_sm90", "halo_conv", "gemm_sm90", "act_quant"):
            variants = {"shipped": [], **variants}
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
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key[0]} variant {key[1]}:\n{log}")
        built[key] = (so, log)
    return built


def register_report(name: str, so: pathlib.Path, log: str) -> None:
    """One line per flash instantiation: what ptxas and the SASS show."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    so.with_suffix(".sass").write_text(sass)
    spills = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*flash_sm90_kernelILi(\d)ELb(\d)", line)
        if m:
            fn = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            spills[fn] = int(m.group(1))
    warned = {}
    for m in re.finditer(r"\((C75\d\d)\)[^']*'\S*flash_sm90_kernelILi(\d)ELb(\d)", log):
        warned.setdefault((int(m.group(2)), int(m.group(3))), set()).add(m.group(1))
    stats, fn, region = {}, None, "entry"
    for line in sass.splitlines():
        m = re.search(r"Function : \S*flash_sm90_kernelILi(\d)ELb(\d)", line)
        if m:
            fn, region = (int(m.group(1)), int(m.group(2))), "entry"
            stats[fn] = {"reg": 0, "local": {"entry": 0, "consumer": 0, "producer": 0},
                         "waits": 0, "setmaxnreg": []}
            continue
        if fn is None:
            continue
        st = stats[fn]
        if "USETMAXREG" in line:
            region = "consumer" if "TRY_ALLOC" in line else "producer"
            st["setmaxnreg"].append(re.search(r"USETMAXREG[^;]*", line).group(0).strip())
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        if regs:
            st["reg"] = max(st["reg"], max(regs))
        if re.search(r"\b(STL|LDL)\b", line):
            st["local"][region] += 1
        if "WARPGROUP.DEPBAR" in line:
            st["waits"] += 1
    for fn in sorted(stats):
        st = stats[fn]
        print(f"registers {name} {KINDS[fn[0]]} {'runmax' if fn[1] else 'fixedm'}: "
              f"warnings {sorted(warned.get(fn, ())) or 'none'}, spill stores "
              f"{spills.get(fn)} bytes, highest R{st['reg']}, local ld/st {st['local']}, "
              f"wgmma waits {st['waits']}, {st['setmaxnreg']}", flush=True)


def entry(so: pathlib.Path, lib: str):
    name, argtypes = ENTRY[lib]
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


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


def install_flash(fn) -> None:
    tfa._lib_sm90 = lambda: fn


def fmt(ts) -> str:
    return " ".join(f"{t:.4f}" for t in ts)


def flash_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(1, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, cs.SKV, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_kv_block(k), quantize_kv_block(v)
    k8, v8 = (x.float().clamp(-448, 448).to(tfa.FP8) for x in (k, v))
    return q, {
        "bf16": lambda qq: tfa.flash_attention_prefix(qq, k, v, cs.SKV),
        "e4m3": lambda qq: tfa.flash_attention_prefix(qq, k8, v8, cs.SKV),
        "int8": lambda qq: tfa.flash_attention_prefix_quant(qq, kq, vq, ks, vs, cs.SKV),
    }


def flash_phase(dev, built) -> None:
    real = entry(built[("flash_attention_sm90", "shipped")][0], "flash_attention_sm90")
    q, runs = flash_inputs(dev)
    for kind, run in runs.items():
        for name in FLASH:
            if name in BYTE_ONLY and kind == "bf16":
                continue
            var = entry(built[("flash_attention_sm90", name)][0], "flash_attention_sm90")
            t_real, t_var = in_turns(lambda: run(q), install_flash, real, var)
            print(f"flash {kind} full cache: kernel {fmt(t_real)} ms, {name} {fmt(t_var)} ms",
                  flush=True)
    # the wave tail: 3 whole rounds against 3.36, with and without the split
    whole = lambda units, sms: (units, 1)  # noqa: E731
    split = tfa.tail_split
    for sq in (33 * tfa.BLOCK_Q, cs.SQ):
        units = -(-sq // tfa.BLOCK_Q) * cs.H
        times = {}
        for label, fn in (("split", split), ("whole", whole), ("whole", whole),
                          ("split", split)):
            tfa.tail_split = fn
            times.setdefault(label, []).append(cs.time_ms(lambda: runs["bf16"](q[:, :sq])))
        tfa.tail_split = split
        n_full, splits = split(units, tfa._sm_count(dev))
        print(f"wave tail bf16 Sq {sq} ({units} units; split: {n_full} whole + "
              f"{units - n_full} x {splits}): split {fmt(times['split'])} ms, every unit "
              f"whole {fmt(times['whole'])} ms", flush=True)
    install_flash(real)


def gemm_register_report(name: str, so: pathlib.Path, log: str) -> None:
    """One line per GEMM instantiation: what ptxas and the SASS show."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    pat = r"gemm_sm90_kernelILb(\d)ELb(\d)ELi(\d+)E"
    spills, warned, fn = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + pat, line)
        if m:
            fn = m.groups()
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            spills[fn] = int(m.group(1))
    for m in re.finditer(r"\((C75\d\d)\)[^']*'\S*" + pat, log):
        warned.setdefault(m.groups()[1:], set()).add(m.group(1))
    stats, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pat, line)
            fn = m.groups() if m else None
            if fn:
                stats[fn] = {"reg": 0, "local": 0, "gmma": 0, "waits": 0, "arrives": 0,
                             "setmaxnreg": []}
            continue
        if fn is None:
            continue
        st = stats[fn]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        if regs:
            st["reg"] = max(st["reg"], max(regs))
        st["local"] += bool(re.search(r"\b(STL|LDL)\b", line))
        st["gmma"] += "GMMA" in line
        st["waits"] += "WARPGROUP.DEPBAR" in line
        st["arrives"] += "WARPGROUP.ARRIVE" in line
        if "USETMAXREG" in line:
            st["setmaxnreg"].append(re.search(r"USETMAXREG[^;]*", line).group(0).strip())
    kinds = {"0": "int8", "1": "fp8"}
    print(f"registers gemm {name}: ptxas warnings "
          f"{sorted(set(re.findall(r'[(](C75[0-9][0-9])[)]', log))) or 'none'}", flush=True)
    for fn in sorted(stats):
        st = stats[fn]
        print(f"  {kinds[fn[0]]} {'f32' if fn[1] == '1' else 'bf16'} out, tile width {fn[2]}: "
              f"warnings {sorted(warned.get(fn, ())) or 'none'}, spill stores "
              f"{spills.get(fn)} bytes, highest R{st['reg']}, local ld/st {st['local']}, "
              f"wgmma {st['gmma']}, waits {st['waits']}, arrives {st['arrives']}, "
              f"{st['setmaxnreg']}", flush=True)


GEMM_SHAPES = cs.LAYER_GEMMS + (("text_kv", cs.TEXT, cs.DIM, cs.DIM, 0),
                                ("o_m9360", 2 * cs.SQ, cs.DIM, cs.DIM, 0))


def gemm_phase(dev, built) -> None:
    """Each GEMM variant against the shipped kernel, in turns."""
    def install(lib):
        _build._LIBS[tk.GEMM_LIBRARY] = lib
    real = ctypes.CDLL(str(built[("gemm_sm90", "shipped")][0]))
    g = torch.Generator(device=dev).manual_seed(7)
    for nm, m, k, n, calls in GEMM_SHAPES:
        xq, wq, xs, ws8, b8 = cs.path_gemm_operands(dev, g, m, k, n)
        x, w8, ws, b = cs.fp8_operands(dev, g, m, k, n)
        runs = {"int8": lambda: tk.int8_matmul(xq, wq, xs, ws8, bias=b8),
                "fp8": lambda: tk.fp8_matmul(x, w8, ws, bias=b)}
        for kind, run in runs.items():
            install(real)
            ref = run()
            for name in GEMM:
                if (kind == "int8" and name in FP8_ONLY) or (kind == "fp8" and name in INT8_ONLY):
                    continue
                var = ctypes.CDLL(str(built[("gemm_sm90", name)][0]))
                install(var)
                # poison the block the output will likely reuse: a variant
                # that writes nothing must not look equal
                torch.full_like(ref, float("nan"))
                out = run()
                same = "=" if torch.equal(out, ref) else \
                    f"max |diff| {(out.float() - ref.float()).abs().max().item():.3e}"
                t_real, t_var = in_turns(run, install, real, var)
                print(f"gemm {kind} {nm} [{m}x{k}]x[{k}x{n}] ({calls} a layer): kernel "
                      f"{fmt(t_real)} ms, {name} {fmt(t_var)} ms {same}", flush=True)
    install(real)


def halo_register_report(name: str, so: pathlib.Path, log: str) -> None:
    """One line per halo conv instantiation: what ptxas and the SASS show."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    pat = r"halo_conv_sm90_kernelILb(\d)ELi(\d+)ELi(\d)"
    spills, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + pat, line)
        if m:
            fn = m.groups()
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            spills[fn] = int(m.group(1))
    warned = sorted(set(re.findall(r"\((C7\d\d\d)\)", log)))
    stats, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pat, line)
            fn = m.groups() if m else None
            if fn:
                stats[fn] = {"reg": 0, "local": 0, "gmma": 0, "waits": 0, "arrives": 0}
            continue
        if fn is None:
            continue
        st = stats[fn]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        if regs:
            st["reg"] = max(st["reg"], max(regs))
        st["local"] += bool(re.search(r"\b(STL|LDL)\b", line))
        st["gmma"] += "GMMA" in line
        st["waits"] += "WARPGROUP.DEPBAR" in line
        st["arrives"] += "WARPGROUP.ARRIVE" in line
    print(f"registers halo {name}: ptxas warnings {warned or 'none'}", flush=True)
    for fn in sorted(stats):
        st = stats[fn]
        print(f"  {'int8' if fn[0] == '1' else 'bf16'} N {fn[1]} {fn[2]} consumer warpgroups: "
              f"spill stores {spills.get(fn)} bytes, highest R{st['reg']}, local ld/st "
              f"{st['local']}, wgmma {st['gmma']}, waits {st['waits']}, arrives "
              f"{st['arrives']}", flush=True)


def halo_phase(dev, built) -> None:
    """Each halo variant against the shipped kernel at three decode classes,
    bf16 and int8, on the same codes and weight operand."""
    def install(lib):
        _build._LIBS["halo_conv"] = lib
    real = ctypes.CDLL(str(built[("halo_conv", "shipped")][0]))
    g = torch.Generator(device=dev).manual_seed(4)
    for cname in ("res 96 480x832", "res 192 240x416", "head 96->3 480x832"):
        _, tin, h, w, cin, cout, kt, _, _ = next(c for c in cs.VAE_CONVS if c[0] == cname)
        x = torch.randn(tin, h, w, cin, generator=g, device=dev).to(torch.bfloat16)
        wt = ((torch.rand(kt, 3, 3, cin, cout, generator=g, device=dev) * 2 - 1)
              * (kt * 9 * cin) ** -0.5).to(torch.bfloat16)
        b = torch.zeros(cout, device=dev)
        for int8 in (False, True):
            install(real)
            pk = thc.pack_weight(wt, w8a8=int8)
            xk, s_x = thc.quantize_conv_act(x) if int8 else (x, None)
            plan = thc.tile_plan(tin, h, w, cin, cout, kt, int8)

            def run(wgs=plan.wgs):
                out = torch.empty(tin - kt + 1, h, w, cout, dtype=torch.bfloat16, device=dev)
                err = thc._library().inferix_halo_conv3d(
                    xk.data_ptr(), pk.wk.data_ptr(), b.data_ptr(),
                    s_x.data_ptr() if int8 else None, pk.s_w.data_ptr() if int8 else None,
                    out.data_ptr(), tin, h, w, cin, cout, kt, plan.n_tile, wgs, int(int8),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"halo variant launch failed: CUDA error {err}")
                return out
            ref = run()
            label = f"halo {cname} {'int8' if int8 else 'bf16'}"
            for name in HALO:
                var = ctypes.CDLL(str(built[("halo_conv", name)][0]))
                install(var)
                same = "=" if torch.equal(run(), ref) else "!="
                t_real, t_var = in_turns(run, install, real, var)
                print(f"{label}: kernel {fmt(t_real)} ms, {name} {fmt(t_var)} ms {same}",
                      flush=True)
            if plan.wgs == 3:
                same = "=" if torch.equal(run(2), ref) else "!="
                times = ([], [])
                for two in (False, True, True, False):
                    times[two].append(cs.time_ms(lambda: run(2 if two else 3)))
                print(f"{label}: kernel {fmt(times[0])} ms, wgs2 {fmt(times[1])} ms {same}",
                      flush=True)
    install(real)


# SASS opcodes (before the first '.') by the pipe that executes them
FP32_OPS = ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I")
XU_OPS = ("MUFU", "F2I", "I2F", "F2F", "F2FP", "FRND")
ACT_NAMES = {0: "None", 1: "gelu", 2: "gelu_exact", 3: "silu_mul"}
MODE_NAMES = {0: "plain", 1: "affine", 2: "modulate"}


def act_quant_report(so: pathlib.Path, log: str) -> dict:
    """One line per row-kernel instantiation; returns {(kind, code, G,
    chunks, resident): (fp32, xu, all) instructions an element}."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    so.with_suffix(".sass").write_text(sass)
    pats = (("quant", r"quant_rows_kernelILi(\d)ELi(\d+)ELi(\d+)ELb(\d)E"),
            ("ln", r"ln_quant_kernelILi(\d)ELi(\d+)ELi(\d+)EE"))

    def key_of(name):
        for kind, pat in pats:
            m = re.search(pat, name)
            if m:
                g = m.groups()
                return (kind, int(g[0]), int(g[1]), int(g[2]), kind == "ln" or g[3] == "1")
        return None
    props, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?:$| )",
                      line)
        if m and key_of(m.group(1)):
            fn = key_of(m.group(1))
            props.setdefault(fn, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            props[fn]["frame"], props[fn]["spill_st"], props[fn]["spill_ld"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            props[fn]["regs"] = int(m.group(1))
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = key_of(line)
            if fn:
                counts[fn] = {"fp32": 0, "xu": 0, "all": 0, "local": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if not (fn and m) or m.group(1) in ("NOP",):
            continue
        op, st = m.group(1), counts[fn]
        st["all"] += 1
        st["fp32"] += op in FP32_OPS
        st["xu"] += op in XU_OPS
        st["local"] += op in ("LDL", "STL")
    per_elem = {}
    for fn in sorted(counts):
        kind, code, g, chunks, resident = fn
        elems = 8 * chunks * (2 if kind == "quant" and g == 16 else 1)
        st, pr = counts[fn], props.get(fn, {})
        per_elem[fn] = tuple(st[c] / elems for c in ("fp32", "xu", "all"))
        name = (f"act {ACT_NAMES[code]}" if kind == "quant" else f"ln {MODE_NAMES[code]}")
        print(f"registers act_quant {name} G {g} "
              f"{f'{chunks} chunks' if resident else 'two-pass'}: "
              f"{pr.get('regs')} registers, stack frame {pr.get('frame')} bytes, spill stores "
              f"{pr.get('spill_st')} / loads {pr.get('spill_ld')} bytes, local ld/st "
              f"{st['local']}; instructions an element (static, /{elems}): FP32 "
              f"{per_elem[fn][0]:.2f}, MUFU + conversions {per_elem[fn][1]:.2f}, all "
              f"{per_elem[fn][2]:.2f}", flush=True)
    return per_elem


def built_class(kind: str, code: int, width: int) -> tuple:
    """The instantiation the launcher takes for rows of `width`."""
    g, nc = taq.row_plan(width)
    chunks = next((most for gg, most in taq.ROW_CLASSES if gg == g and nc <= most), None)
    return (kind, code, g, chunks or 1, chunks is not None)


def act_quant_phase(dev, built) -> None:
    """Each act_quant variant against the shipped kernels at the path's
    calls, in turns."""
    def install(lib):
        _build._LIBS["act_quant"] = lib
    real = ctypes.CDLL(str(built[("act_quant", "shipped")][0]))
    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(cs.SQ, cs.FFN, generator=g, device=dev) * 2).to(torch.bfloat16)
    xo = x[:, :cs.DIM].contiguous()
    kv = torch.randn(2 * cs.SQ * cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    mod = torch.randn(1, 3, 6, cs.DIM, generator=g, device=dev) * 0.5
    w3 = (1 + 0.1 * torch.randn(cs.DIM, generator=g, device=dev)).to(torch.bfloat16)
    b3 = (0.1 * torch.randn(cs.DIM, generator=g, device=dev)).to(torch.bfloat16)
    calls = {
        "o/cross_o [4680x1536]": lambda: taq.quantize_rows_int8(xo),
        "fc2_in gelu [4680x8960]": lambda: taq.quantize_rows_int8(x, act="gelu"),
        "kv_write_b2 [112320x128]": lambda: taq.quantize_rows_int8(kv),
        "adaln [4680x1536]": lambda: taq.adaln_quantize_rows_int8(xo[None], mod[:, :, 0],
                                                                  mod[:, :, 1]),
        "ln affine [4680x1536]": lambda: taq.ln_quantize_rows_int8(xo, w3, b3),
    }
    # variants that change one call's kernel only: the calls they are timed at
    only = {"f32_modulate": ("adaln",), "ln_rows8": ("adaln", "ln"),
            "ln_rows4": ("adaln", "ln"), "g16_rows1": ("kv_write",)}
    for label, run in calls.items():
        install(real)
        ref = run()
        for name in VARIANTS["act_quant"]:
            if name in only and not label.startswith(only[name]):
                continue
            var = ctypes.CDLL(str(built[("act_quant", name)][0]))
            install(var)
            out = run()
            same = "=" if all(torch.equal(a, b) for a, b in zip(out, ref)) else "!="
            t_real, t_var = in_turns(run, install, real, var)
            print(f"act_quant {label}: kernel {fmt(t_real)} ms, {name} {fmt(t_var)} ms {same}",
                  flush=True)
    install(real)


def act_quant_bounds(per_elem: dict) -> None:
    """Each W8A8 path call's instruction bounds beside its bytes bound."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes_a_ms = sms * mhz * 1e3  # SM clocks a ms, all SMs
    print(f"act_quant bounds at {mhz:.0f} MHz x {sms} SMs", flush=True)
    for label, kind, code, m, k, k_out, extra in (
            ("o/cross_o", "quant", 0, cs.SQ, cs.DIM, cs.DIM, 0),
            ("fc2_in gelu", "quant", 1, cs.SQ, cs.FFN, cs.FFN, 0),
            ("kv_write_b2", "quant", 0, 2 * cs.SQ * cs.H, cs.D, cs.D, 0),
            ("adaln qkv/fc1", "ln", 2, cs.SQ, cs.DIM, cs.DIM, 2 * 3 * cs.DIM * 4),
            ("ln affine cross_q", "ln", 1, cs.SQ, cs.DIM, cs.DIM, 2 * cs.DIM * 2)):
        fp32, xu, total = per_elem[built_class(kind, code, k_out)]
        n = m * k_out
        t = {"FP32": n * fp32 / 128 / lanes_a_ms, "MUFU + conversions": n * xu / 16 / lanes_a_ms,
             "issue": n * total / 128 / lanes_a_ms}
        print(f"act_quant bound {label} [{m}x{k}]: bytes {cs.quant_bound(m, k, k_out, extra):.4f} "
              f"ms; instructions " + ", ".join(f"{p} {v:.4f} ms" for p, v in t.items()),
              flush=True)


def qattn_register_report(name: str, so: pathlib.Path, log: str) -> None:
    """One line per int8-PV kernel instantiation and the pre-pass kernel."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    so.with_suffix(".sass").write_text(sass)

    def key_of(text):
        m = re.search(r"flash_quant_sm90_kernelILi(\d)E", text)
        if m:
            return ("i8", "v2")[int(m.group(1))]
        return "pre-pass" if "quant_operands_kernel" in text else None
    props, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = key_of(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            props.setdefault(fn, {})["spill"] = int(m.group(1))
    warned = {}
    for m in re.finditer(r"\((C75\d\d)\)[^']*'(\S+)'", log):
        k = key_of(m.group(2))
        if k:
            warned.setdefault(k, set()).add(m.group(1))
    stats, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = key_of(line)
            if fn:
                stats[fn] = {"reg": 0, "IGMMA": 0, "HGMMA": 0, "waits": 0, "arrives": 0,
                             "local": 0, "setmaxnreg": []}
            continue
        if fn is None:
            continue
        st = stats[fn]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        if regs:
            st["reg"] = max(st["reg"], max(regs))
        st["IGMMA"] += "IGMMA" in line
        st["HGMMA"] += "HGMMA" in line
        st["waits"] += "WARPGROUP.DEPBAR" in line
        st["arrives"] += "WARPGROUP.ARRIVE" in line
        st["local"] += bool(re.search(r"\b(STL|LDL)\b", line))
        if "USETMAXREG" in line:
            st["setmaxnreg"].append(re.search(r"USETMAXREG[^;]*", line).group(0).strip())
    for fn in sorted(stats):
        st = stats[fn]
        print(f"registers qattn {name} {fn}: warnings {sorted(warned.get(fn, ())) or 'none'}, "
              f"spill stores {props.get(fn, {}).get('spill')} bytes, highest R{st['reg']}, "
              f"local ld/st {st['local']}, IGMMA {st['IGMMA']}, HGMMA {st['HGMMA']}, wgmma "
              f"waits {st['waits']}, arrives {st['arrives']}, {st['setmaxnreg']}", flush=True)


def qattn_phase(dev, built) -> None:
    """The pre-pass pieces timed, then each int8-PV variant against the
    shipped kernel at the full cache, in turns."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(1, cs.SQ, cs.H, cs.D, generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv_block(torch.randn(1, cs.SKV, cs.H, cs.D, generator=g, device=dev)
                               .to(torch.bfloat16))
    vq, vs = quantize_kv_block(torch.randn(1, cs.SKV, cs.H, cs.D, generator=g, device=dev)
                               .to(torch.bfloat16))
    for label, fn in (("quant_operands (V^T)", lambda: tfa.quant_operands(kq, vq, False)),
                      ("quant_operands (V^T, bf16 K)", lambda: tfa.quant_operands(kq, vq, True)),
                      ("quant_ext_rows i8", lambda: tfa.quant_ext_rows("i8", ks, vs, 2048)),
                      ("quant_ext_rows v2", lambda: tfa.quant_ext_rows("v2", ks, vs, 2048))):
        print(f"qattn pre-pass {label}: {cs.time_ms(fn):.4f} ms", flush=True)

    def install(fn):
        tfa._lib_quant_sm90 = lambda: fn
    real = ctypes.CDLL(str(built[("flash_attention_sm90", "shipped")][0]))
    real_fn = real.inferix_flash_attention_quant_sm90
    real_fn.argtypes, real_fn.restype = tfa._ARGTYPES_QUANT_SM90, ctypes.c_int
    for mode, kern in (("i8", tfa.flash_attention_prefix_quant_i8),
                       ("v2", tfa.flash_attention_prefix_quant_v2)):
        run = lambda: kern(q, kq, vq, ks, vs, cs.SKV)  # noqa: E731
        install(real_fn)
        ref = run()
        plain = tfa.quant_ext_reference(mode, q, kq, vq, ks, vs, cs.SKV, None, None,
                                        False).float()
        bound, _ = cs.quant_attention_bound(mode, 1, cs.SKV)
        for name in QATTN:
            var = ctypes.CDLL(str(built[("flash_attention_sm90", name)][0]))
            var_fn = var.inferix_flash_attention_quant_sm90
            var_fn.argtypes, var_fn.restype = tfa._ARGTYPES_QUANT_SM90, ctypes.c_int
            install(var_fn)
            out = run()
            same = "=" if torch.equal(out, ref) else \
                f"max |out - plain| {(out.float() - plain).abs().max().item():.3e}"
            t_real, t_var = in_turns(run, install, real_fn, var_fn)
            print(f"qattn {mode} full cache (bound {bound:.4f} ms): kernel {fmt(t_real)} ms, "
                  f"{name} {fmt(t_var)} ms {same}", flush=True)
    install(real_fn)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gemm", action="store_true",
                    help="the quantized GEMMs' variants instead of the flash ones")
    ap.add_argument("--halo", action="store_true",
                    help="the halo conv's variants instead of the flash ones")
    ap.add_argument("--act-quant", action="store_true",
                    help="the row quantizers' registers and instruction counts instead")
    ap.add_argument("--qattn", action="store_true",
                    help="the int8-PV attention kernels' registers and variants instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    if args.qattn:
        built = build_variants(["flash_attention_sm90"], QATTN)
        for (_, name), (so, log) in built.items():
            qattn_register_report(name, so, log)
        qattn_phase(dev, built)
        return
    if args.act_quant:
        built = build_variants(["act_quant"])
        act_quant_bounds(act_quant_report(*built[("act_quant", "shipped")]))
        for (_, name), (so, log) in built.items():
            if name != "shipped":
                print(f"registers act_quant variant {name}:", flush=True)
                act_quant_report(so, log)
        act_quant_phase(dev, built)
        return
    if args.halo:
        built = build_variants(["halo_conv"])
        for (_, name), (so, log) in built.items():
            halo_register_report(name, so, log)
        halo_phase(dev, built)
        return
    if args.gemm:
        built = build_variants(["gemm_sm90"])
        for (_, name), (so, log) in built.items():
            gemm_register_report(name, so, log)
        gemm_phase(dev, built)
        return
    _build.build(["flash_attention_sm90"])
    built = build_variants(["flash_attention_sm90"])
    for (lib, name), (so, log) in built.items():
        register_report(name, so, log)
    flash_phase(dev, built)


if __name__ == "__main__":
    main()
