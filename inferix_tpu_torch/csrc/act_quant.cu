// Per-token int8 activation quantization for NVIDIA Hopper (sm_90a): the
// act-quant kernel and the LayerNorm (+modulate / +affine) + quant kernel.
//
// Replaces the TPU kernels of inferix_tpu/ops/act_quant.py:
//   quant_rows_kernel  <- `_quant_kernel` (:66, pallas_call :117, wrapper
//                         quantize_rows_int8 :94)
//   ln_quant_kernel    <- `_ln_mod_quant_kernel` (:154), both of its
//                         pallas_calls: modulate (:228, wrapper
//                         adaln_quantize_rows_int8 :199) and plain / affine
//                         (:277, wrapper ln_quantize_rows_int8 :256)
//
// Contract: x [M, K] bf16, row-major and 16-byte aligned, K % 8 == 0. Out:
// codes s8 [M, K'] and one f32 scale per row, scale = max(absmax / 127, 1e-8)
// and code = clip(round_half_even(v / scale), -127, 127), v being the row's
// value after the optional activation (K' = K / 2 for silu_mul, which reads
// [gate | up]) or after the LayerNorm and its modulate / affine step.
//
// Numerics follow the JAX chain at each rounding point: every step is an
// explicit _rn intrinsic (no FMA contraction, IEEE division, no
// --use_fast_math), rounding is __float2int_rn (half to even, as jnp.round),
// gelu uses the accurate tanhf, and a value is rounded to bf16 where the JAX
// chain holds it in the activation dtype. The LayerNorm takes
// 1 / sqrt(var + eps) (IEEE) where the TPU kernel takes rsqrt.
//
// Bound on an H100 SXM: bytes. Each row is read once from device memory (2K
// bytes) and K' + 4 bytes are written. At the main path's largest call, the
// gelu fold in front of fc2 (4680 x 8960), that is 83.9 MB read + 41.9 MB
// written -> 0.0375 ms at 3.35 TB/s; each 4680 x 1536 input, 21.6 MB ->
// 0.0064 ms. The arithmetic (a tanh per element at most) is far below the
// card's rate.
//
// Design (simple and right first): one CTA of 256 threads per row, 16-byte
// vector loads. The act-quant kernel reads its row twice (the absmax pass,
// then the code pass; the second read finds the row in L1/L2), so it has no
// width limit. The LayerNorm kernel keeps its row in shared memory as f32
// (K <= 12288): one read from device memory serves the mean, the variance,
// the normalised value and the absmax. Block reductions go through warp
// shuffles and a 32-float shared array.
//
// C interface: raw pointers, the stream; the launchers allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLnWidth = 12288;

enum Act { kActNone = 0, kActGelu = 1, kActGeluExact = 2, kActSiluMul = 3 };
enum Mode { kPlain = 0, kAffine = 1, kModulate = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive bf16 (one 16-byte load) as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 codes of v / scale, packed for one 8-byte store.
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int code = __float2int_rn(__fdiv_rn(v[i], scale));
    code = max(-127, min(127, code));
    w[i >> 2] |= (static_cast<uint32_t>(code) & 0xffu) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// Sum or max over the CTA; every thread gets the result. `red` holds 32
// floats of shared memory and may be reused by the next call.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (static_cast<int>(blockDim.x) >> 5) ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
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

// The 8 values of chunk c of a row after the activation, as the JAX kernel
// holds them: f32, rounded to bf16 wherever that chain rounds.
template <int kAct>
__device__ __forceinline__ void act_chunk(const __nv_bfloat16* xr, int c,
                                          int out_k, float (&v)[8]) {
  load8(xr + c * 8, v);
  if (kAct == kActGelu) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bf16_round(gelu_tanh(v[i]));
  } else if (kAct == kActGeluExact) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = erf_as(__fmul_rn(v[i], 0.7071067811865476f));
      v[i] = bf16_round(__fmul_rn(__fmul_rn(0.5f, v[i]), __fadd_rn(1.0f, e)));
    }
  } else if (kAct == kActSiluMul) {
    float up[8];
    load8(xr + out_k + c * 8, up);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v[i])));
      const float gate = bf16_round(__fmul_rn(v[i], sig));
      v[i] = bf16_round(__fmul_rn(gate, up[i]));  // bf16 * bf16 -> bf16
    }
  }
}

template <int kAct>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, int k, int out_k) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * k;
  const int chunks = out_k >> 3;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float v[8];
    act_chunk<kAct>(xr, c, out_k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = block_reduce<true>(amax, red);
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  int8_t* qr = q + row * out_k;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float v[8];
    act_chunk<kAct>(xr, c, out_k, v);
    *reinterpret_cast<uint2*>(qr + c * 8) = quant8(v, scale);
  }
  if (threadIdx.x == 0) s[row] = scale;
}

struct LnParams {
  const __nv_bfloat16* x;
  int8_t* q;
  float* s;
  const void* p0;  // modulate: shift f32; affine: weight bf16
  const void* p1;  // modulate: scale f32; affine: bias bf16
  long long mod_sb, mod_sf;  // modulation strides (batch, frame), elements
  int C, rows_per_batch, frame_seq;
  float eps;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) ln_quant_kernel(LnParams p) {
  extern __shared__ float buf[];  // the row, then its quantizer inputs
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int C = p.C;
  const __nv_bfloat16* xr = p.x + row * C;

  float sum = 0.0f;
  for (int c = threadIdx.x; c < (C >> 3); c += blockDim.x) {
    float v[8];
    load8(xr + c * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      buf[c * 8 + i] = v[i];
      sum = __fadd_rn(sum, v[i]);
    }
  }
  const float mean = __fdiv_rn(block_reduce<false>(sum, red), static_cast<float>(C));
  float sq = 0.0f;
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    const float d = __fsub_rn(buf[e], mean);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_reduce<false>(sq, red), static_cast<float>(C));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));

  const float* shift = nullptr;
  const float* scale_mod = nullptr;
  if (kMode == kModulate) {
    const long long b = row / p.rows_per_batch;
    const long long f = (row % p.rows_per_batch) / p.frame_seq;
    const long long off = b * p.mod_sb + f * p.mod_sf;
    shift = static_cast<const float*>(p.p0) + off;
    scale_mod = static_cast<const float*>(p.p1) + off;
  }
  float amax = 0.0f;
  for (int e = threadIdx.x; e < C; e += blockDim.x) {
    const float ln = __fmul_rn(__fsub_rn(buf[e], mean), inv);
    float h;
    if (kMode == kModulate) {
      // h = bf16(ln); bf16(bf16(h * bf16(1 + scale)) + bf16(shift))
      const float sc = bf16_round(__fadd_rn(1.0f, scale_mod[e]));
      const float sh = bf16_round(shift[e]);
      h = bf16_round(__fadd_rn(bf16_round(__fmul_rn(bf16_round(ln), sc)), sh));
    } else if (kMode == kAffine) {
      const float w = __bfloat162float(static_cast<const __nv_bfloat16*>(p.p0)[e]);
      const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(p.p1)[e]);
      h = bf16_round(__fadd_rn(__fmul_rn(ln, w), b));
    } else {
      h = bf16_round(ln);
    }
    buf[e] = h;
    amax = fmaxf(amax, fabsf(h));
  }
  amax = block_reduce<true>(amax, red);  // its barriers also publish buf
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  int8_t* qr = p.q + row * C;
  for (int c = threadIdx.x; c < (C >> 3); c += blockDim.x) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = buf[c * 8 + i];
    *reinterpret_cast<uint2*>(qr + c * 8) = quant8(v, scale);
  }
  if (threadIdx.x == 0) p.s[row] = scale;
}

template <int kAct>
cudaError_t launch_quant(const __nv_bfloat16* x, int8_t* q, float* s, int m,
                         int k, cudaStream_t stream) {
  const int out_k = kAct == kActSiluMul ? k / 2 : k;
  quant_rows_kernel<kAct><<<m, kThreads, 0, stream>>>(x, q, s, k, out_k);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_ln(const LnParams& p, int m, cudaStream_t stream) {
  const int smem = p.C * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ln_quant_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ln_quant_kernel<kMode><<<m, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int inferix_quantize_rows_int8(const void* x, void* q, void* s,
                                          int m, int k, int act, void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActNone: return static_cast<int>(launch_quant<kActNone>(xp, qp, sp, m, k, st));
    case kActGelu: return static_cast<int>(launch_quant<kActGelu>(xp, qp, sp, m, k, st));
    case kActGeluExact:
      return static_cast<int>(launch_quant<kActGeluExact>(xp, qp, sp, m, k, st));
    case kActSiluMul: return static_cast<int>(launch_quant<kActSiluMul>(xp, qp, sp, m, k, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int inferix_ln_quantize_rows_int8(
    const void* x, void* q, void* s, const void* p0, const void* p1,
    long long mod_sb, long long mod_sf, int m, int c, int rows_per_batch,
    int frame_seq, float eps, int mode, void* stream) {
  if (c <= 0 || c > kMaxLnWidth || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LnParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<int8_t*>(q);
  p.s = static_cast<float*>(s);
  p.p0 = p0;
  p.p1 = p1;
  p.mod_sb = mod_sb;
  p.mod_sf = mod_sf;
  p.C = c;
  p.rows_per_batch = rows_per_batch;
  p.frame_seq = frame_seq;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(launch_ln<kPlain>(p, m, st));
    case kAffine: return static_cast<int>(launch_ln<kAffine>(p, m, st));
    case kModulate: return static_cast<int>(launch_ln<kModulate>(p, m, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
