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
// f32, so the only roundings are the f32 sums (tensor-core order), the scale
// product (__fmul_rn), the cast and the bias sum: the TPU kernel's contract
// (acc * ws, then astype), with the bias added after the cast as
// quantized_linear adds it. Requires K % 16 == 0 and N % 8 == 0 (the
// tensor maps' 16-byte row strides, the 16-byte output stores).
//
// Bound on an H100 SXM: operations. 2*M*N*K bf16 operations at 989 TFLOP/s
// against (2*M*K + N*K + 2*M*N) bytes at 3.35 TB/s. On the main path
// (M = 4680) one layer's six linears are 390.1 GFLOP -> 0.3944 ms, against
// ~382 MB -> 0.114 ms; the e4m3 weights halve the weight bytes, which does
// not move an operations-bound GEMM. Only wgmma reaches the tensor cores'
// rate on this card, so the design is built around it.
//
// Design: the transposed product out^T = W . x^T, so that the weight is
// wgmma's *register* A operand and is widened in registers, never written
// back to shared memory as bf16 (the widening choice: in the consumers'
// registers, after two 4-byte shared loads a row and k16 step). A CTA of 2
// warpgroups (256 threads) computes 128 channels x 256 tokens:
//   - thread 0 keeps a 4-stage ring of TMA loads 3 k-steps ahead (x tile
//     [256 tokens x 64 k] bf16 with the 128-byte swizzle, which wgmma reads
//     as its K-major B operand; the raw e4m3 tile [128 channels x 64 k], 8
//     KB, with the 64-byte swizzle) under mbarriers with expected byte
//     counts, and refills a slot once both warpgroups have freed it (8 warp
//     arrivals), while its own warpgroup's products run.
//   - each warpgroup owns 64 channels. The A fragment of thread t of a quad
//     holds k = 2t, 2t+1, 8+2t, 9+2t of each k16 step: two 4-byte loads a
//     row and k16 step (bytes 4(t>>1).. and 8+4(t>>1)..) and one byte_perm
//     gather them, conflict-free thanks to the swizzle; 16 e4m3 pairs are
//     widened to bf16x2 (cvt via f16, exact); four wgmma m64n256k16 take A
//     from registers and B = the x tile through its smem descriptor. The
//     accumulator is 128 f32 a thread (212 registers in all); its rows are
//     channels, so the per-channel scale and bias are one value a row.
//   - Why no producer warp: a CTA of more than 256 threads gets at most 168
//     registers a thread (the register file over 12 warps, whatever
//     setmaxnreg says), too few for 128 accumulators plus the A fragments:
//     ptxas then serialises the wgmma (C7512); on the H100 a producer
//     warpgroup ran no faster and a producer warp slower (PERF.md).
// The epilogue scales, rounds once (_rn), adds the bias after the cast,
// stages the [256 tokens x 128 channels] tile through the (drained) ring,
// transposed, and writes it with coalesced 16-byte stores. Ragged edges: TMA
// zero-fills x rows past M and k past K (x and w), and the stores are
// masked; M = 1, 70, 512 and 4680 and the K = 16, N = 8 edge run the same
// kernel, with no size switch. The descriptors (cuTensorMapEncodeTiled,
// taken from the driver through cudaGetDriverEntryPoint, no -lcuda) are
// built per call on the host and passed as __grid_constant__ parameters.
//
// C interface: raw pointers, the stream; the launcher allocates nothing,
// does not synchronise, and returns a CUDA error code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;                          // channels a CTA
constexpr int kBT = 256;                          // tokens a CTA
constexpr int kBK = 64;                           // k a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;                     // 2 warpgroups
constexpr int kXBytes = kBT * kBK * 2;            // 32 KB, swizzled bf16 x
constexpr int kWBytes = kBN * kBK;                // 8 KB, raw e4m3 w (64-byte swizzle)
constexpr int kStageBytes = kXBytes + kWBytes;    // multiple of 1024
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBarBytes = 2 * kStages * 8;
constexpr int kSmemBytes = kRingBytes + kBarBytes + 1024;  // + alignment slack
constexpr int kStageBf16 = kBN + 8;               // staging row (elements)
constexpr int kStageF32 = kBN + 4;
static_assert(kBT * kStageF32 * 4 <= kRingBytes, "staging fits the ring");

struct Params {
  const float* ws;
  const void* bias;
  void* out;
  int ws_stride;
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase with the given parity has completed. A wait that
// never ends (a lost arrival) traps after 2^22 polls (~15 s on an H100), so a fault
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers at this point of the program: asm volatile
// statements keep their order, so reads of r stay after a wgmma wait and
// writes before the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Two e4m3 bytes (the low 16 bits of w >> shift) widened to bf16x2, exactly:
// e4m3 -> f16 is exact, f16 -> f32 -> bf16 keeps 3 mantissa bits.
__device__ __forceinline__ uint32_t widen2(uint32_t w, int shift) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>((w >> shift) & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The A-fragment bytes of thread t4 of a quad in row `row` of the raw weight
// tile (64-byte rows, TMA's 64-byte swizzle: 16-byte chunk c of row r sits
// at chunk c ^ ((r >> 1) & 3)), k16 step kk: k = 16kk + (2t4, 2t4+1, 8+2t4,
// 9+2t4), gathered from two 4-byte words by one byte_perm.
__device__ __forceinline__ uint32_t gather4(const uint8_t* tile, int row, int kk,
                                            int t4) {
  const uint8_t* chunk = tile + row * kBK + ((kk ^ ((row >> 1) & 3)) << 4);
  const uint32_t a = *reinterpret_cast<const uint32_t*>(chunk + 4 * (t4 >> 1));
  const uint32_t b = *reinterpret_cast<const uint32_t*>(chunk + 8 + 4 * (t4 >> 1));
  return __byte_perm(a, b, (t4 & 1) ? 0x7632u : 0x5410u);
}

// D[64 x 256] += A[64 x 16] (registers, bf16) * B[16 x 256] (smem
// descriptor, K-major).
__device__ __forceinline__ void wgmma_m64n256k16_ra(float (&d)[128], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <bool kOutF32>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kStages;       // stage consumed (8 consumer warps)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBT;
  const int nk = (p.K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 keeps the TMA ring kStages - 1 k-steps ahead.
  auto issue = [&](int i) {
    const int s = i % kStages;
    uint8_t* st = smem + s * kStageBytes;
    mbar_expect_tx(&full[s], kStageBytes);
    tma_load_2d(st, &tm_x, &full[s], i * kBK, m0);
    tma_load_2d(st + kXBytes, &tm_w, &full[s], i * kBK, n0);
  };
  if (tid == 0)
    for (int i = 0; i < min(kStages - 1, nk); ++i) issue(i);
  {
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;      // channel rows r0, r0 + 8
    float acc[kBT / 2];
#pragma unroll
    for (int i = 0; i < kBT / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      mbar_wait(&full[s], par);
      const uint8_t* st = smem + s * kStageBytes;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t lo = gather4(st + kXBytes, r0, kk, t4);
        const uint32_t hi = gather4(st + kXBytes, r0 + 8, kk, t4);
        a[kk][0] = widen2(lo, 0);
        a[kk][1] = widen2(hi, 0);
        a[kk][2] = widen2(lo, 16);
        a[kk][3] = widen2(hi, 16);
      }
      const uint32_t xaddr = smem_u32(st);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_ra(acc, a[kk], sw128_desc(xaddr + kk * 32), 1);
      wgmma_commit();
      // refill the slot of k-step kt - 1 once both warpgroups are done with
      // it, while this k-step's products run
      if (tid == 0 && kt + kStages - 1 < nk) {
        if (kt > 0) mbar_wait(&empty[(kt - 1) % kStages], ((kt - 1) / kStages) & 1);
        issue(kt + kStages - 1);
      }
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: scale, round, bias; stage [token][channel]; coalesced stores.
    __syncthreads();  // both warpgroups are off the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = r0 + 8 * h;                  // channel within the CTA
      const int ch = n0 + c;
      const bool live = ch < p.N;
      const float ws = live ? p.ws[static_cast<long long>(ch) * p.ws_stride] : 0.f;
      float bsum = 0.f;
      if (live && p.bias != nullptr)
        bsum = kOutF32 ? static_cast<const float*>(p.bias)[ch]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[ch]);
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = 8 * j + 2 * t4 + e;
          float v = __fmul_rn(acc[4 * j + 2 * h + e], ws);
          if (kOutF32) {
            if (p.bias != nullptr) v = __fadd_rn(v, bsum);
            reinterpret_cast<float*>(smem)[tok * kStageF32 + c] = v;
          } else {
            __nv_bfloat16 r = __float2bfloat16_rn(v);
            if (p.bias != nullptr)
              r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), bsum));
            reinterpret_cast<__nv_bfloat16*>(smem)[tok * kStageBf16 + c] = r;
          }
        }
      }
    }
    __syncthreads();
    constexpr int kElem = kOutF32 ? 4 : 2;
    constexpr int kRowChunks = kBN * kElem / 16;
    constexpr int kRow = kOutF32 ? kStageF32 : kStageBf16;
    for (int i = tid; i < kBT * kRowChunks; i += 256) {
      const int tok = i / kRowChunks, cc = i % kRowChunks;
      const int gm = m0 + tok, gn = n0 + cc * (16 / kElem);
      if (gm < p.M && gn < p.N) {
        const uint4 v = *reinterpret_cast<const uint4*>(smem + (tok * kRow) * kElem + cc * 16);
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.out) +
                                  (static_cast<long long>(gm) * p.N + gn) * kElem) = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D row-major map: `rows` rows of `cols` elements, `pitch` bytes apart;
// box = box_rows x box_cols.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
               uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kOutF32>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fp8_matmul_kernel<kOutF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBT - 1) / kBT);
  fp8_matmul_kernel<kOutF32><<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int inferix_fp8_matmul(const void* x, const void* w, const void* ws,
                                  int ws_stride, const void* bias, void* out,
                                  int M, int N, int K, int out_f32,
                                  void* stream) {
  if (K % 16 != 0 || N % 8 != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2ull * K, kBK, kBT,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K, kBK, kBN,
                 CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.ws = static_cast<const float*>(ws);
  p.bias = bias;
  p.out = out;
  p.ws_stride = ws_stride;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch<true>(tx, tw, p, s) : launch<false>(tx, tw, p, s));
}
