// Per-token int8 activation quantization for NVIDIA Hopper (sm_90a): the
// act-quant kernel and the LayerNorm (+modulate / +affine) + quant kernel,
// on one register-resident row-quantizer frame.
//
// Replaces the TPU kernels of inferix_tpu/ops/act_quant.py:
//   quant_rows_kernel  <- `_quant_kernel` (:66, pallas_call :117, wrapper
//                         quantize_rows_int8 :94)
//   ln_quant_kernel    <- `_ln_mod_quant_kernel` (:154), both of its
//                         pallas_calls: modulate (:228, wrapper
//                         adaln_quantize_rows_int8 :199) and plain / affine
//                         (:277, wrapper ln_quantize_rows_int8 :256)
//
// The act-quant kernel has two more stages for the rows of a tensor-parallel
// row linear, where each rank holds 1/tp of a row and the scale is the
// absmax of the whole row: stage 1 writes the local row absmax (of the
// activation's result) in place of the scale and no code; stage 2 reads the
// row absmax the caller reduced over the ranks (a MAX, exact) and writes the
// codes and the scale from it, as stage 0 would for the whole row
// (ops/act_quant.py: row_absmax, quantize_rows_int8_given).
//
// Contract: x [M, K] bf16, row-major and 16-byte aligned, K % 8 == 0. Out:
// codes s8 [M, K'] and one f32 scale per row, scale = max(absmax / 127, 1e-8)
// and code = clip(round_half_even(v / scale), -127, 127), v being the row's
// value after the optional activation (K' = K / 2 for silu_mul, which reads
// [gate | up]) or after the LayerNorm and its modulate / affine step.
//
// Numerics follow the JAX chain at each rounding point: every step is an
// explicit _rn intrinsic (no FMA contraction of the chain's operations, the
// IEEE quotient for every division, no --use_fast_math), rounding is
// __float2int_rn (half to even, as jnp.round), gelu uses the accurate tanhf,
// and a value is rounded to bf16 where the JAX chain holds it in the
// activation dtype. The LayerNorm takes
// 1 / sqrt(var + eps) (IEEE) where the TPU kernel takes rsqrt.
//
// Bound on an H100 SXM: bytes. Each row is read once from device memory (2K
// bytes) and K' + 4 bytes are written: 0.0064 ms for a 4680 x 1536 input,
// 0.0130 ms for the int8 K/V write at B=2 (112320 rows of 128). The gelu fold
// (4680 x 8960, 0.0376 ms of bytes) evaluates an accurate tanh per element
// and sits near its instruction bound instead (exp/kernel_variants.py
// --act-quant counts the SASS).
//
// Design. Every value the quantizer reads is exactly a bf16 (the input, the
// activation's result, the LayerNorm's h), so a row is held in registers as
// packed bf16: a group of G threads owns a row, lane l holding its 16-byte
// chunks l, l + G, l + 2G, ... (neighbouring lanes on neighbouring addresses).
// The row is read from device memory once by 16-byte loads, its activation
// computed once, its absmax (and the LayerNorm's mean and variance) reduced
// from registers, and its codes written from registers by 8-byte stores. The
// wrapper picks the class from the width (ops/act_quant.py:row_plan) and
// passes G and the chunks a thread; the launcher refuses a class it was not
// built for:
//   G 16:  1 chunk (widths <= 128): two rows a warp, two rows a group at a
//          time (the int8 K/V write);
//   G 32:  up to 6 chunks (<= 1536): one warp a row, no barrier and no
//          shared memory;
//   G 128: up to 9 or 12 chunks (<= 9216, <= 12288): one 4-warp CTA a row.
//          A wider act-quant row takes the same kernel reading the row twice
//          (the absmax pass, then the code pass).
// Reductions are warp shuffles within the group, and across the 4 warps of a
// G 128 row through 8 floats of shared memory used in turns (one barrier a
// reduction). Each group takes kRows rows (the LayerNorm kernel kLnRows, a
// contiguous run), and the grid covers the rows once. A LayerNorm CTA
// stages bf16(1 + scale) and bf16(shift) of the frames its rows touch (one
// or two at 1560 rows a frame), or the affine weight and bias, in shared
// memory once for all its groups, so a thread's registers hold its row
// alone (a group's own modulation in registers took 152 registers a thread
// and ~12 KB of L2 reads a group).
//
// The instructions an element are what bounds the calls that a register
// row makes cheap in bytes (exp/kernel_variants.py --act-quant counts
// them), so the arithmetic is laid out for them, every result unchanged:
// v / scale is the IEEE quotient from the row's reciprocal and two exact
// corrections (no reciprocal and no range check an element), the absmax
// and the modulate run on bf16 pairs, and the codes are packed by byte
// permutes.
//
// C interface: raw pointers, the class, the stream; the launchers allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kActNone = 0, kActGelu = 1, kActGeluExact = 2, kActSiluMul = 3 };
enum Mode { kPlain = 0, kAffine = 1, kModulate = 2 };
enum Stage { kWhole = 0, kAbsmax = 1, kGiven = 2 };

// The row classes (mirrored by ops/act_quant.py:ROW_CLASSES): G threads a
// row, each holding at most kChunks 16-byte chunks of it in registers.
// kRows rows a group of the act-quant kernel loads at once; kThreads
// threads a CTA (4 warps: register-limited occupancy in fine steps).
template <int G, int kChunks_>
struct RowClass {
  static constexpr int kChunks = kChunks_;
  static constexpr int kRows = G == 16 ? 2 : 1;
  static constexpr int kThreads = G == 16 ? 256 : 128;
  static constexpr int kGroups = kThreads / G;
};
// Rows a group of the LayerNorm kernel takes in turn.
constexpr int kLnRows = 2;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The 8 bf16 of a 16-byte chunk as floats (exact).
__device__ __forceinline__ void unpack8(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 floats rounded to bf16 (to nearest, ties to even) and packed.
__device__ __forceinline__ uint4 pack8_rn(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t bf16x2_abs(uint32_t a) {
  uint32_t d;
  asm("abs.bf16x2 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// max of two bf16 pairs; a NaN loses to a number, as in fmaxf
__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a * b + c on bf16 pairs, the exact result rounded once to bf16
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bf16(bf16(h * sc) + sh) on bf16 pairs: h * sc + (-0), then * 1 + sh.
__device__ __forceinline__ uint32_t modulate2(uint32_t h, uint32_t sc, uint32_t sh) {
  return bf16x2_fma(bf16x2_fma(h, sc, 0x80008000u), 0x3f803f80u, sh);
}

// The running absmax of bf16 pairs, as a bf16 pair (max is exact, so its
// order is free: a tree a chunk keeps the dependency chain short).
__device__ __forceinline__ uint32_t absmax8(const uint4& h, uint32_t amax2) {
  const uint32_t a = bf16x2_max(bf16x2_abs(h.x), bf16x2_abs(h.y));
  const uint32_t b = bf16x2_max(bf16x2_abs(h.z), bf16x2_abs(h.w));
  return bf16x2_max(amax2, bf16x2_max(a, b));
}

// The f32 sum of 8 values as a tree (the LayerNorm's sums take this order).
__device__ __forceinline__ float sum8(const float (&v)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

__device__ __forceinline__ float pair_max(uint32_t amax2) {
  return fmaxf(__uint_as_float(amax2 << 16), __uint_as_float(amax2 & 0xffff0000u));
}

// The row's divisor: the scale and its correctly rounded reciprocal.
struct Divisor {
  float b, y;
};

__device__ __forceinline__ Divisor divisor_of(float amax) {
  const float b = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  return {b, __frcp_rn(b)};
}

// RN(a / b), the IEEE quotient, from y = RN(1 / b): q0 = RN(a y) is within
// 1.5 ulps of a / b; one correction q + (a - b q) y (the residual exact by
// fma) makes it faithful, and a second one, by Markstein's theorem, rounds
// it correctly. Holds while a - b q is representable: here b >= 1e-8 and
// |a| <= 127 b, so a residual could only underflow for a quotient far below
// 0.5, whose code is 0 either way. chip_smoke.py holds it against IEEE
// division over every bf16 absmax and every bf16 value within 8 binades of
// it. 5 FP32 operations where __fdiv_rn takes a reciprocal, 5 and a check.
__device__ __forceinline__ float quotient(float a, Divisor d) {
  float q = __fmul_rn(a, d.y);
  q = __fmaf_rn(__fmaf_rn(-d.b, q, a), d.y, q);
  return __fmaf_rn(__fmaf_rn(-d.b, q, a), d.y, q);
}

// 8 codes of v / scale, packed for one 8-byte store. The clip to +-127 is
// never active: |v| <= absmax, so |v / scale| <= 127 (1 + 2^-24) rounds to
// at most 127 (a NaN converts to 0, as before); the low bytes of the
// two's-complement codes are packed.
__device__ __forceinline__ uint2 quant8(const uint4& h, Divisor d) {
  float v[8];
  unpack8(h, v);
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = static_cast<uint32_t>(__float2int_rn(quotient(v[i], d)));
  const uint32_t lo = __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040),
                                  0x5410);
  const uint32_t hi = __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040),
                                  0x5410);
  return make_uint2(lo, hi);
}

// Sum or max over the G threads of a row; every thread of the group gets the
// same value (the butterfly pairs equal partials). G 128, a whole CTA, goes
// on through `red`: 2 x 4 floats of shared memory used in turns, so one
// barrier a call suffices (a warp writes a slot again only after the next
// call's barrier, which every reader of the slot has passed).
template <int G, bool kMax>
__device__ __forceinline__ float group_reduce(float v, float (*red)[4], int& turn) {
  constexpr int kWidth = G < 32 ? G : 32;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  if constexpr (G > 32) {
    float* r = red[turn];
    turn ^= 1;
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    v = r[0];
#pragma unroll
    for (int i = 1; i < G / 32; ++i) v = kMax ? fmaxf(v, r[i]) : __fadd_rn(v, r[i]);
  }
  return v;
}

// jax.nn.gelu(approximate=True) in f32: 0.5 x (1 + tanh(c (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, x3));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// Abramowitz-Stegun 7.1.26, the TPU kernel's erf (act_quant.py:48).
__device__ __forceinline__ float erf_as(float z) {
  const float ax = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(__fmul_rn(1.061405429f, t), -1.453152027f);
  p = __fadd_rn(__fmul_rn(p, t), 1.421413741f);
  p = __fadd_rn(__fmul_rn(p, t), -0.284496736f);
  p = __fadd_rn(__fmul_rn(p, t), 0.254829592f);
  p = __fmul_rn(p, t);
  const float y = __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-ax, ax))));
  return z < 0.0f ? -y : y;
}

// A chunk after the activation, rounded to bf16 where the JAX kernel rounds
// it (every act rounds its result), packed; `up` is silu_mul's up chunk.
template <int kAct>
__device__ __forceinline__ uint4 act8(const uint4& raw, const uint4& up) {
  if (kAct == kActNone) return raw;
  float v[8];
  unpack8(raw, v);
  if (kAct == kActGelu) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu_tanh(v[i]);
  } else if (kAct == kActGeluExact) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = erf_as(__fmul_rn(v[i], 0.7071067811865476f));
      v[i] = __fmul_rn(__fmul_rn(0.5f, v[i]), __fadd_rn(1.0f, e));
    }
  } else {
    float u[8];
    unpack8(up, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v[i])));
      const float gate = bf16_round(__fmul_rn(v[i], sig));
      v[i] = __fmul_rn(gate, u[i]);  // bf16 * bf16 -> bf16 (rounded by the pack)
    }
  }
  return pack8_rn(v);
}

// The act-quant kernel. Group g of the grid takes rows [g * per, g * per +
// per); every group runs `per` iterations, so the rows past M (dead) still
// join the group's reductions and only skip their loads and stores.
template <int kAct, int G, int kChunks, bool kResident, int kStage>
__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, const float* __restrict__ amax_in, int m, int k,
                  int out_k, int per) {
  using RC = RowClass<G, kChunks>;
  constexpr int kGroups = RC::kGroups;
  constexpr int kRows = kResident ? RC::kRows : 1;
  __shared__ float red[2][4];
  int turn = 0;
  const int lane = threadIdx.x % G;
  const int n = out_k >> 3;
  const long long begin =
      (static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / G) * per;
  const long long end = min(static_cast<long long>(m), begin + per);
  for (int i = 0; i < per; i += kRows) {
    long long row[kRows];
    bool live[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      row[u] = begin + i + u;
      live[u] = row[u] < end;
    }
    Divisor d[kRows];
    float amax[kRows];
    if constexpr (kResident) {
      uint4 v[kRows][kChunks], up[kRows][kChunks];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const __nv_bfloat16* xr = x + row[u] * k;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = j * G + lane;
          v[u][j] = up[u][j] = make_uint4(0u, 0u, 0u, 0u);
          if (live[u] && c < n) {
            v[u][j] = load16(xr + c * 8);
            if (kAct == kActSiluMul) up[u][j] = load16(xr + out_k + c * 8);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        uint32_t amax2 = 0u;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          if (live[u] && j * G + lane < n) {
            v[u][j] = act8<kAct>(v[u][j], up[u][j]);
            if (kStage != kGiven) amax2 = absmax8(v[u][j], amax2);
          }
        }
        if constexpr (kStage == kGiven)
          amax[u] = live[u] ? __ldg(amax_in + row[u]) : 0.0f;
        else
          amax[u] = group_reduce<G, true>(pair_max(amax2), red, turn);
        d[u] = divisor_of(amax[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows && kStage != kAbsmax; ++u) {
        int8_t* qr = q + row[u] * out_k;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = j * G + lane;
          if (live[u] && c < n)
            *reinterpret_cast<uint2*>(qr + c * 8) = quant8(v[u][j], d[u]);
        }
      }
    } else {  // past the register classes: the absmax pass, then the code pass
      const __nv_bfloat16* xr = x + row[0] * k;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      uint32_t amax2 = 0u;
      for (int c = lane; kStage != kGiven && live[0] && c < n; c += G) {
        const uint4 u = kAct == kActSiluMul ? load16(xr + out_k + c * 8) : zero;
        amax2 = absmax8(act8<kAct>(load16(xr + c * 8), u), amax2);
      }
      if constexpr (kStage == kGiven)
        amax[0] = live[0] ? __ldg(amax_in + row[0]) : 0.0f;
      else
        amax[0] = group_reduce<G, true>(pair_max(amax2), red, turn);
      d[0] = divisor_of(amax[0]);
      int8_t* qr = q + row[0] * out_k;
      for (int c = lane; kStage != kAbsmax && live[0] && c < n; c += G) {
        const uint4 u = kAct == kActSiluMul ? load16(xr + out_k + c * 8) : zero;
        *reinterpret_cast<uint2*>(qr + c * 8) = quant8(act8<kAct>(load16(xr + c * 8), u), d[0]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (live[u] && lane == 0) s[row[u]] = kStage == kAbsmax ? amax[u] : d[u].b;
  }
}

struct LnParams {
  const __nv_bfloat16* x;
  int8_t* q;
  float* s;
  const void* p0;  // modulate: shift f32; affine: weight bf16
  const void* p1;  // modulate: scale f32; affine: bias bf16
  long long mod_sb, mod_sf;  // modulation strides (batch, frame), elements
  int m, C, rows_per_batch, frame_seq, per;
  float eps;
};

// 8 consecutive bf16 (an affine weight or bias, which may be a view):
// one 16-byte load when aligned, else 8 2-byte loads.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return load16(p);
  const auto* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(__ldg(h + 2 * i)) |
           (static_cast<uint32_t>(__ldg(h + 2 * i + 1)) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16(one + p[i]) for 8 consecutive f32 of a modulation row (a strided
// view): two 16-byte loads when aligned, else 8 4-byte loads.
__device__ __forceinline__ uint4 load8_f32_as_bf16(const float* p, float one) {
  float v[8];
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(one, v[i]);
  return pack8_rn(v);
}

// The next row's chunks into registers (zeros for a dead row).
template <int G, int kChunks>
__device__ __forceinline__ void load_row(uint4 (&xv)[kChunks], const __nv_bfloat16* xr,
                                         bool live, int lane, int n) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = j * G + lane;
    xv[j] = live && c < n ? load16(xr + c * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The frames a run of `rows` consecutive rows can touch (frames of
// frame_seq rows): the modulation slots a CTA stages.
__host__ __device__ inline int frame_slots(int rows, int frame_seq) {
  return (rows - 1 + frame_seq - 1) / frame_seq + 1;
}

// Shared memory of the LayerNorm kernel, bytes, for rows of n chunks: the
// CTA stages bf16(1 + scale) and bf16(shift) of each frame its rows touch
// (modulate), or the affine weight and bias, once for all its groups.
template <int kMode>
int ln_smem_bytes(int rows_per_cta, int frame_seq, int n) {
  return kMode == kModulate ? frame_slots(rows_per_cta, frame_seq) * 2 * n * 16
                            : kMode == kAffine ? 2 * n * 16 : 0;
}

// The LayerNorm kernel: one row at a time a group, rows as the act-quant
// kernel takes them (a CTA's groups take consecutive runs). The modulation
// and affine operands are staged in shared memory by the whole CTA, its
// first rows' loads in flight meanwhile, so a thread's registers hold its
// chunks of the row alone.
template <int kMode, int G, int kChunks>
__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads) ln_quant_kernel(LnParams p) {
  using RC = RowClass<G, kChunks>;
  constexpr int kGroups = RC::kGroups;
  extern __shared__ uint4 operands[];
  __shared__ float red[2][4];
  int turn = 0;
  const int lane = threadIdx.x % G;
  const int C = p.C, n = C >> 3;
  const long long begin =
      (static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / G) * p.per;
  const long long end = min(static_cast<long long>(p.m), begin + p.per);
  uint4 xv[kChunks];
  load_row<G>(xv, p.x + begin * C, begin < end, lane, n);
  // slot s holds operand chunk c at [2 n s + c] and [2 n s + n + c]: frame
  // key0 + s (a frame's key is its row / frame_seq; batches hold whole
  // frames), or the affine weight and bias in slot 0
  const long long key0 = static_cast<long long>(blockIdx.x) * kGroups * p.per / p.frame_seq;
  if (kMode == kModulate) {
    const long long last = min(static_cast<long long>(p.m),
                               static_cast<long long>(blockIdx.x + 1) * kGroups * p.per) - 1;
    const int frames = p.rows_per_batch / p.frame_seq;
    for (int slot = 0; slot <= static_cast<int>(last / p.frame_seq - key0); ++slot) {
      const long long key = key0 + slot;
      const long long off = key / frames * p.mod_sb + key % frames * p.mod_sf;
      uint4* dst = operands + 2 * n * slot;
      for (int c = threadIdx.x; c < n; c += RC::kThreads) {
        dst[c] = load8_f32_as_bf16(static_cast<const float*>(p.p1) + off + c * 8, 1.0f);
        dst[n + c] = load8_f32_as_bf16(static_cast<const float*>(p.p0) + off + c * 8, -0.0f);
      }
    }
    __syncthreads();
  } else if (kMode == kAffine) {
    for (int c = threadIdx.x; c < n; c += RC::kThreads) {
      operands[c] = load8_bf16(static_cast<const __nv_bfloat16*>(p.p0) + c * 8);
      operands[n + c] = load8_bf16(static_cast<const __nv_bfloat16*>(p.p1) + c * 8);
    }
    __syncthreads();
  }
  for (int i = 0; i < p.per; ++i) {
    const long long row = begin + i;
    const bool live = row < end;
    if (i > 0) load_row<G>(xv, p.x + row * C, live, lane, n);
    const uint4* pair =
        kMode == kModulate ? operands + 2 * n * (live ? row / p.frame_seq - key0 : 0) : operands;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * G + lane < n) {
        float v[8];
        unpack8(xv[j], v);
        sum = __fadd_rn(sum, sum8(v));
      }
    }
    const float mean = __fdiv_rn(group_reduce<G, false>(sum, red, turn), static_cast<float>(C));
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * G + lane < n) {
        float v[8];
        unpack8(xv[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(v[e], mean);
          v[e] = __fmul_rn(d, d);
        }
        sq = __fadd_rn(sq, sum8(v));
      }
    }
    const float var = __fdiv_rn(group_reduce<G, false>(sq, red, turn), static_cast<float>(C));
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    uint32_t amax2 = 0u;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = j * G + lane;
      if (c < n) {
        float v[8], h[8];
        unpack8(xv[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = __fmul_rn(__fsub_rn(v[e], mean), inv);
        if (kMode == kModulate) {
          // h = bf16(ln); bf16(bf16(h * bf16(1 + scale)) + bf16(shift)), on
          // bf16 pairs: each product and sum is taken exactly and rounded
          // once, which equals the f32 operation rounded to bf16 outside the
          // subnormal range. A product of two bf16 values is exact in f32. A
          // sum of two bf16 values is exact in f32 unless their exponents
          // differ by 16 or more; then the smaller is below 2^-8 of the
          // larger's bf16 ulp, so the exact sum and its f32 rounding both lie
          // far from a midpoint of the bf16 grid and round to the same bf16.
          const uint4 hb = pack8_rn(h), sc = pair[c], sh = pair[n + c];
          xv[j] = make_uint4(modulate2(hb.x, sc.x, sh.x), modulate2(hb.y, sc.y, sh.y),
                             modulate2(hb.z, sc.z, sh.z), modulate2(hb.w, sc.w, sh.w));
        } else {
          if (kMode == kAffine) {  // the f32 affine step, cast once
            float w[8], bb[8];
            unpack8(pair[c], w);
            unpack8(pair[n + c], bb);
#pragma unroll
            for (int e = 0; e < 8; ++e) h[e] = __fadd_rn(__fmul_rn(h[e], w[e]), bb[e]);
          }
          xv[j] = pack8_rn(h);  // the last rounding to bf16
        }
        amax2 = absmax8(xv[j], amax2);
      }
    }
    const Divisor d = divisor_of(group_reduce<G, true>(pair_max(amax2), red, turn));
    if (live) {
      int8_t* qr = p.q + row * C;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = j * G + lane;
        if (c < n) *reinterpret_cast<uint2*>(qr + c * 8) = quant8(xv[j], d);
      }
      if (lane == 0) p.s[row] = d.b;
    }
  }
}

// Each group takes `per` rows in turn; the grid covers the rows once.
template <int kGroups>
int ctas_for(int m, int per) {
  return static_cast<int>((m + static_cast<long long>(per) * kGroups - 1) /
                          (static_cast<long long>(per) * kGroups));
}

template <int kAct, int G, int kChunks, bool kResident, int kStage>
cudaError_t launch_quant(const __nv_bfloat16* x, int8_t* q, float* s, const float* amax_in,
                         int m, int k, int out_k, cudaStream_t stream) {
  using RC = RowClass<G, kChunks>;
  const int per = kResident ? RC::kRows : 1;
  quant_rows_kernel<kAct, G, kChunks, kResident, kStage>
      <<<ctas_for<RC::kGroups>(m, per), RC::kThreads, 0, stream>>>(x, q, s, amax_in, m, k,
                                                                   out_k, per);
  return cudaGetLastError();
}

// The dynamic shared memory opt-in. cudaFuncSetAttribute sets a kernel's
// attribute for the device current at the call, not for the process: a
// process that launches on several cards (a decode card beside the
// generator's) opts in once on each, or its launches past 48 KB fail there
// with cudaErrorInvalidValue. Each library keeps its own copy (its build key
// hashes its one source).
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t smem_opt_in(Kernel* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int kMode, int G, int kChunks>
cudaError_t launch_ln(LnParams p, cudaStream_t stream) {
  using RC = RowClass<G, kChunks>;
  constexpr int kRowsPerCta = RC::kGroups * kLnRows;
  // the most the class can stage (one frame a row, the widest row): past the
  // default 48 KB for the wide rows
  static bool opted[kMaxDevices] = {};
  const cudaError_t opt_in = smem_opt_in(ln_quant_kernel<kMode, G, kChunks>,
                                         ln_smem_bytes<kMode>(kRowsPerCta, 1, kChunks * G),
                                         opted);
  if (opt_in != cudaSuccess) return opt_in;
  p.per = kLnRows;
  ln_quant_kernel<kMode, G, kChunks>
      <<<ctas_for<RC::kGroups>(p.m, p.per), RC::kThreads,
         ln_smem_bytes<kMode>(kRowsPerCta, p.frame_seq, p.C >> 3), stream>>>(p);
  return cudaGetLastError();
}

// The plan covers a row of n chunks exactly as ops/act_quant.py:row_plan
// does: nc = ceil(n / g).
bool covers(int n, int g, int nc) {
  return nc >= 1 && static_cast<long long>(nc - 1) * g < n &&
         static_cast<long long>(nc) * g >= n;
}

// The classes built (ops/act_quant.py:ROW_CLASSES): G 16 with 1 chunk a
// thread, G 32 with up to 6, G 128 with up to 9 or 12; past 12 the
// act-quant kernel's two-pass row (G 128). Anything else is refused.
template <int kAct, int kStage>
cudaError_t quant_class(const __nv_bfloat16* x, int8_t* q, float* s, const float* a, int m,
                        int k, int g, int nc, cudaStream_t st) {
  const int o = kAct == kActSiluMul ? k / 2 : k;
  if (g == 16 && nc <= 1) return launch_quant<kAct, 16, 1, true, kStage>(x, q, s, a, m, k, o, st);
  if (g == 32 && nc <= 6) return launch_quant<kAct, 32, 6, true, kStage>(x, q, s, a, m, k, o, st);
  if (g == 128 && nc <= 9)
    return launch_quant<kAct, 128, 9, true, kStage>(x, q, s, a, m, k, o, st);
  if (g == 128 && nc <= 12)
    return launch_quant<kAct, 128, 12, true, kStage>(x, q, s, a, m, k, o, st);
  if (g == 128) return launch_quant<kAct, 128, 1, false, kStage>(x, q, s, a, m, k, o, st);
  return cudaErrorInvalidValue;
}

template <int kStage>
cudaError_t quant_act(const void* x, void* q, void* s, const void* a, int m, int k, int act,
                      int g, int nc, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  const auto* ap = static_cast<const float*>(a);
  switch (act) {
    case kActNone: return quant_class<kActNone, kStage>(xp, qp, sp, ap, m, k, g, nc, st);
    case kActGelu: return quant_class<kActGelu, kStage>(xp, qp, sp, ap, m, k, g, nc, st);
    case kActGeluExact:
      return quant_class<kActGeluExact, kStage>(xp, qp, sp, ap, m, k, g, nc, st);
    case kActSiluMul: return quant_class<kActSiluMul, kStage>(xp, qp, sp, ap, m, k, g, nc, st);
    default: return cudaErrorInvalidValue;
  }
}

bool quant_args_ok(int m, int k, int act, int g, int nc) {
  const int out_k = act == kActSiluMul ? k / 2 : k;
  return m > 0 && k > 0 && k % (act == kActSiluMul ? 16 : 8) == 0 && covers(out_k / 8, g, nc);
}

template <int kMode>
cudaError_t ln_class(const LnParams& p, int g, int nc, cudaStream_t st) {
  if (g == 16 && nc <= 1) return launch_ln<kMode, 16, 1>(p, st);
  if (g == 32 && nc <= 6) return launch_ln<kMode, 32, 6>(p, st);
  if (g == 128 && nc <= 9) return launch_ln<kMode, 128, 9>(p, st);
  if (g == 128 && nc <= 12) return launch_ln<kMode, 128, 12>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int inferix_quantize_rows_int8(const void* x, void* q, void* s, int m, int k,
                                          int act, int g, int nc, void* stream) {
  if (!quant_args_ok(m, k, act, g, nc)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(quant_act<kWhole>(x, q, s, nullptr, m, k, act, g, nc,
                                            static_cast<cudaStream_t>(stream)));
}

// The tensor-parallel stages: stage 1 writes each row's absmax into s (q is
// not written); stage 2 takes each row's absmax from amax_in and writes the
// codes and the scales.
extern "C" int inferix_quantize_rows_int8_tp(const void* x, void* q, void* s,
                                             const void* amax_in, int m, int k, int act,
                                             int g, int nc, int stage, void* stream) {
  if (!quant_args_ok(m, k, act, g, nc) || (stage == kGiven && amax_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == kAbsmax)
    return static_cast<int>(quant_act<kAbsmax>(x, q, s, nullptr, m, k, act, g, nc, st));
  if (stage == kGiven)
    return static_cast<int>(quant_act<kGiven>(x, q, s, amax_in, m, k, act, g, nc, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int inferix_ln_quantize_rows_int8(
    const void* x, void* q, void* s, const void* p0, const void* p1,
    long long mod_sb, long long mod_sf, int m, int c, int rows_per_batch,
    int frame_seq, float eps, int mode, int g, int nc, void* stream) {
  if (m <= 0 || c <= 0 || c % 8 != 0 || !covers(c / 8, g, nc) ||
      (mode == kModulate && (rows_per_batch <= 0 || frame_seq <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  LnParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<int8_t*>(q);
  p.s = static_cast<float*>(s);
  p.p0 = p0;
  p.p1 = p1;
  p.mod_sb = mod_sb;
  p.mod_sf = mod_sf;
  p.m = m;
  p.C = c;
  p.rows_per_batch = rows_per_batch;
  p.frame_seq = frame_seq;
  p.per = 0;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(ln_class<kPlain>(p, g, nc, st));
    case kAffine: return static_cast<int>(ln_class<kAffine>(p, g, nc, st));
    case kModulate: return static_cast<int>(ln_class<kModulate>(p, g, nc, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
