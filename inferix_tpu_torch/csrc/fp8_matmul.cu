// fp8 (e4m3) weight-only GEMM with the scale epilogue for NVIDIA Hopper
// (sm_90a): bf16 activations times e4m3 weights widened to bf16 in the
// kernel, float32 accumulation, the per-channel scale in the epilogue.
//
// Replaces the TPU kernel `_fp8_matmul_kernel` of
// inferix_tpu/quant/kernels.py (kernel body :171, pallas_call :229, wrapper
// fp8_matmul :194), and with it the XLA chain that the JAX package's
// quantized_linear takes for e4m3 weights by default (quant/api.py:127-133).
//
// Contract: x [M, K] bf16 row-major (never quantized); w [N, K] e4m3fn
// row-major, i.e. the JAX package's [K, N] weight held K-contiguous
// (quant.api.to_kernel_layout); w_scale f32, one per column (stride 1) or
// one for all (stride 0); optional bias [N] in the output type; out [M, N]
// bf16 or f32.
//   out[m, n] = cast(f32(sum_k x[m, k] * w[n, k]) * w_scale[n])
//   then, with a bias, cast(f32(out[m, n]) + f32(bias[n]))
// Every e4m3fn value is exact in bf16, and a bf16 x e4m3 product is exact in
// f32, so the only roundings are the f32 sums (mma order), the scale product
// (__fmul_rn), the cast and the bias sum: the TPU kernel's contract
// (acc * ws, then astype), with the bias added after the cast as
// quantized_linear adds it. Requires K % 16 == 0 (16-byte cp.async of the
// weight) and N % 8 == 0.
//
// Bound on an H100 SXM: operations. 2*M*N*K bf16 operations at 989 TFLOP/s
// against (2*M*K + N*K + 2*M*N) bytes at 3.35 TB/s. On the main path
// (M = 4680) one layer's six linears are 390.1 GFLOP -> 0.3944 ms, against
// ~382 MB -> 0.114 ms; the e4m3 weights halve the weight bytes, which does
// not move an operations-bound GEMM.
//
// Design (simple and right first; wgmma, TMA and a native-fp8 variant are
// later work): the int8 GEMM's frame (csrc/int8_matmul.cu). A CTA of 8
// warps computes a 128 x 128 output tile; each warp owns 64 x 32 of it and
// keeps 64 f32 accumulators a thread. K advances 64 values a step through a
// 3-stage cp.async ring: the x tile lands as bf16 (128 rows x 128 bytes),
// the weight tile raw (128 rows x 64 bytes of e4m3). One pass over shared
// memory widens the current weight tile into a bf16 tile (128 x 128 bytes;
// the conversion the flash kernel uses for e4m3 K/V,
// csrc/flash_attention_prefix.cu), and ldmatrix reads it non-transposed,
// as the flash kernel reads its keys: the [N, K] layout is what makes the
// `col` operand of mma.sync.m16n8k16 a plain ldmatrix. Tiles are
// XOR-swizzled in 16-byte chunks so ldmatrix reads are conflict-free.
// Ragged edges (M = 4680 or 512 against the 128-row tile, K tails) are
// zero-filled by cp.async with a source size of 0 and masked on the store:
// no padding copies, unlike the TPU wrapper's jnp.pad.
//
// C interface: raw pointers, the stream; the launcher allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;                            // K values a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;                      // 8 warps: 2 (M) x 4 (N)
constexpr int kATile = kBM * kBK * 2;              // 16 KB of bf16 x
constexpr int kWRaw = kBN * kBK;                   // 8 KB of e4m3 w
constexpr int kStageBytes = kATile + kWRaw;
constexpr int kWTile = kBN * kBK * 2;              // 16 KB of widened w
constexpr int kSmemBytes = kStages * kStageBytes + kWTile;  // 88 KB
constexpr int kAChunks = kATile / 16 / kThreads;   // 4 a thread
constexpr int kWChunks = kWRaw / 16 / kThreads;    // 2 a thread

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* ws;
  const void* bias;
  void* out;
  int ws_stride;
  int M, N, K;
};

// Byte offset of (row, 16-byte chunk) in a tile of 128-byte rows, the chunk
// XOR-swizzled by the row: 8 rows at one chunk land in 8 bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float e4m3_to_float(uint32_t byte) {
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(f);
}

// Four e4m3 bytes (one 32-bit word) widened to four bf16 values (exact).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(e4m3_to_float(w & 0xffu),
                                                  e4m3_to_float((w >> 8) & 0xffu));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(e4m3_to_float((w >> 16) & 0xffu),
                                                  e4m3_to_float(w >> 24));
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// Stage k-tile kt: x rows m0.. as bf16 (8 chunks of 8 values a row,
// swizzled), w rows n0.. raw (4 chunks of 16 values a row, unswizzled).
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* stage,
                                           int m0, int n0, int kt) {
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 3, chunk = c & 7;
    const int k = k0 + chunk * 8;
    const int gm = m0 + row;
    const bool ok = k < p.K && gm < p.M;  // K % 16 == 0: a chunk is whole
    cp_async16(stage + swz(row, chunk),
               ok ? p.x + static_cast<long long>(gm) * p.K + k : p.x, ok);
  }
  uint8_t* raw = stage + kATile;
#pragma unroll
  for (int i = 0; i < kWChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 2, chunk = c & 3;
    const int k = k0 + chunk * 16;
    const int gn = n0 + row;
    const bool ok = k < p.K && gn < p.N;
    cp_async16(raw + row * kBK + chunk * 16,
               ok ? p.w + static_cast<long long>(gn) * p.K + k : p.w, ok);
  }
}

template <bool kOutF32>
__global__ void __launch_bounds__(kThreads, 2) fp8_matmul_kernel(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sW = smem + kStages * kStageBytes;     // the widened bf16 w tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;        // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (p.K + kBK - 1) / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(p, smem + s * kStageBytes, m0, n0, s);
    cp_async_commit();
  }

  // ldmatrix row addresses: A x4 = rows 0-15 of an m16 tile at k-chunks
  // (0, 1) of a k16 step; B x4 = two n8 tiles at k-chunks (0, 1).
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(p, smem + (pf % kStages) * kStageBytes, m0, n0, pf);
    cp_async_commit();

    const uint8_t* sa = smem + (kt % kStages) * kStageBytes;
    // widen: each thread two 16-byte raw chunks -> four 16-byte bf16 chunks
    const uint8_t* raw = sa + kATile;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c >> 2, chunk = c & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + row * kBK + chunk * 16);
      const uint2 a = widen4(v.x), b = widen4(v.y), cc = widen4(v.z), d = widen4(v.w);
      *reinterpret_cast<uint4*>(sW + swz(row, 2 * chunk)) = make_uint4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<uint4*>(sW + swz(row, 2 * chunk + 1)) = make_uint4(cc.x, cc.y, d.x, d.y);
    }
    __syncthreads();  // the widened tile is complete

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], sa + swz(wm * 64 + mi * 16 + a_row, kk * 2 + a_chunk));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], sW + swz(wn * 32 + nj * 16 + b_row, kk * 2 + b_chunk));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: rows g and g + 8 of each m16 tile, columns 2*t4 and 2*t4 + 1
  // of each n8 tile.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (col >= p.N) continue;  // N is even: col + 1 < N too
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float ws = p.ws[static_cast<long long>(col + j) * p.ws_stride];
          v[j] = __fmul_rn(acc[mi][ni][half * 2 + j], ws);
        }
        const long long o = static_cast<long long>(row) * p.N + col;
        if (kOutF32) {
          if (p.bias != nullptr) {
            const float* b = static_cast<const float*>(p.bias);
            v[0] = __fadd_rn(v[0], b[col]);
            v[1] = __fadd_rn(v[1], b[col + 1]);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(v[0], v[1]);
        } else {
          __nv_bfloat16 r0 = __float2bfloat16_rn(v[0]);
          __nv_bfloat16 r1 = __float2bfloat16_rn(v[1]);
          if (p.bias != nullptr) {
            const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p.bias);
            r0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r0), __bfloat162float(b[col])));
            r1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r1), __bfloat162float(b[col + 1])));
          }
          __nv_bfloat162 pair;
          pair.x = r0;
          pair.y = r1;
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = pair;
        }
      }
    }
  }
}

template <bool kOutF32>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fp8_matmul_kernel<kOutF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  fp8_matmul_kernel<kOutF32><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int inferix_fp8_matmul(const void* x, const void* w, const void* ws,
                                  int ws_stride, const void* bias, void* out,
                                  int M, int N, int K, int out_f32,
                                  void* stream) {
  if (K % 16 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.bias = bias;
  p.out = out;
  p.ws_stride = ws_stride;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<true>(p, s) : launch<false>(p, s));
}
