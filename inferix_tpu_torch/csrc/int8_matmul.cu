// W8A8 int8 GEMM with the scale epilogue for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_int8_matmul_kernel` of
// inferix_tpu/quant/kernels.py (kernel body :81, pallas_call :145, wrapper
// int8_matmul :107), and with it the XLA int8 dot_general that the JAX
// package's quantized_linear / quantized_linear_prequant use by default
// (quant/api.py:111-126, :160-176).
//
// Contract: x [M, K] s8 row-major; w [N, K] s8 row-major, i.e. the JAX
// package's [K, N] weight held K-contiguous; x_scale f32, one per row
// (stride 1) or one for all (stride 0); w_scale f32, one per column or one
// for all; optional bias [N] in the output type; out [M, N] bf16 or f32.
//   out[m, n] = cast(f32(sum_k x[m, k] * w[n, k]) * x_scale[m] * w_scale[n])
//   then, with a bias, cast(f32(out[m, n]) + f32(bias[n]))
// The sum is exact in int32 (|acc| <= 127^2 * K); f32(acc) is
// __int2float_rn, the two products and the bias sum are separate _rn
// operations in that order (nvcc may not contract them into an FMA), and the
// casts round to nearest even: the arithmetic of quantized_linear's epilogue,
// which rounds the product to the output dtype before adding the bias.
// Requires K % 16 == 0 (16-byte cp.async) and N % 8 == 0.
//
// Bound on an H100 SXM: operations. 2*M*N*K int8 operations at 1979 TOP/s
// against (M*K + N*K + out) bytes at 3.35 TB/s. On the main path (M = 4680):
// fc1 and fc2 (1536 <-> 8960) 128.8 GOP -> 0.065 ms; qkv (1536 -> 4608)
// 66.2 GOP -> 0.033 ms; each 1536 x 1536 linear 22.1 GOP -> 0.011 ms.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work): a CTA of 8 warps computes a 128 x 128 output tile; each warp
// owns 64 x 32 of it and keeps 64 int32 accumulators a thread. K advances in
// 128-byte steps through a 3-stage cp.async ring in shared memory (A and B
// tiles of 128 rows x 128 bytes, 96 KB in all, 16-byte chunks XOR-swizzled by
// row so ldmatrix reads are conflict-free). Products are
// mma.sync.m16n8k32.s8.s8.s32. The `col` operand of that instruction must be
// K-contiguous and ldmatrix transposes 16-bit elements only, which is why
// the weight is held [N, K]: then ldmatrix (non-transposed) hands each
// thread exactly the 4 consecutive K bytes of one column that the
// instruction expects. Ragged edges (M = 4680 against the 128-row tile, K
// tails) are zero-filled by cp.async with a source size of 0 and masked on
// the store: no padding copies, unlike the TPU wrapper's jnp.pad.
//
// C interface: raw pointers, the stream; the launcher allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 128;                         // bytes of K a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;                    // 8 warps: 2 (M) x 4 (N)
constexpr int kTileBytes = kBM * kBK;            // 16 KB, A and B alike
constexpr int kSmemBytes = kStages * 2 * kTileBytes;  // 96 KB
constexpr int kChunksPerThread = kTileBytes / 16 / kThreads;  // 4

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  const void* bias;
  void* out;
  int xs_stride, ws_stride;
  int M, N, K;
};

// Byte offset of (row, 16-byte chunk) in a 128 x 128-byte tile, the chunk
// XOR-swizzled by the row: 8 rows at one chunk land in 8 bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kBK + ((chunk ^ (row & 7)) << 4);
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

// d += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-tile kt of A (rows m0..) and B (rows n0..) into `stage`.
__device__ __forceinline__ void load_stage(const Params& p, int8_t* stage,
                                           int m0, int n0, int kt) {
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 3, chunk = c & 7;
    const int k = k0 + chunk * 16;
    const bool kin = k < p.K;
    const int gm = m0 + row;
    const bool va = kin && gm < p.M;
    cp_async16(stage + swz(row, chunk),
               va ? p.x + static_cast<long long>(gm) * p.K + k : p.x, va);
    const int gn = n0 + row;
    const bool vb = kin && gn < p.N;
    cp_async16(stage + kTileBytes + swz(row, chunk),
               vb ? p.w + static_cast<long long>(gn) * p.K + k : p.w, vb);
  }
}

template <bool kOutF32>
__global__ void __launch_bounds__(kThreads, 2) int8_matmul_kernel(Params p) {
  extern __shared__ __align__(128) int8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;        // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (p.K + kBK - 1) / kBK;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(p, smem + s * 2 * kTileBytes, m0, n0, s);
    cp_async_commit();
  }

  // ldmatrix row addresses: A x4 = rows 0-15 of an m16 tile at k-chunks
  // (0, 1) of a k32 step; B x4 = two n8 tiles at k-chunks (0, 1).
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(p, smem + (pf % kStages) * 2 * kTileBytes, m0, n0, pf);
    cp_async_commit();

    const int8_t* sa = smem + (kt % kStages) * 2 * kTileBytes;
    const int8_t* sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], sa + swz(wm * 64 + mi * 16 + a_row, kk * 2 + a_chunk));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], sb + swz(wn * 32 + nj * 16 + b_row, kk * 2 + b_chunk));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
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
      const float xs = p.xs[static_cast<long long>(row) * p.xs_stride];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (col >= p.N) continue;  // N is even: col + 1 < N too
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float ws = p.ws[static_cast<long long>(col + j) * p.ws_stride];
          v[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), xs), ws);
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
      int8_matmul_kernel<kOutF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  int8_matmul_kernel<kOutF32><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int inferix_int8_matmul(const void* x, const void* w,
                                   const void* xs, int xs_stride,
                                   const void* ws, int ws_stride,
                                   const void* bias, void* out, int M, int N,
                                   int K, int out_f32, void* stream) {
  if (K % 16 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = bias;
  p.out = out;
  p.xs_stride = xs_stride;
  p.ws_stride = ws_stride;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<true>(p, s) : launch<false>(p, s));
}
