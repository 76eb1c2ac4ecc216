// The port's two quantized GEMMs for NVIDIA Hopper (sm_90a) on one frame:
// the W8A8 int8 GEMM (B3) and the fp8 (e4m3) weight-only GEMM (B8), each
// with its scale epilogue, on warpgroup MMA (wgmma) fed by TMA.
//
// Replaces two TPU kernels of inferix_tpu/quant/kernels.py, and with them
// the XLA chains that the JAX package's quantized_linear takes by default
// (quant/api.py:111-133, :160-176):
//   `_int8_matmul_kernel` (body :81, pallas_call :145, wrapper int8_matmul
//   :107): s8 x s8 with exact int32 sums, then acc.astype(f32) * xs * ws;
//   `_fp8_matmul_kernel` (body :171, pallas_call :229, wrapper fp8_matmul
//   :194): bf16 x times e4m3 weights widened exactly, f32 sums, acc * ws.
//
// Contracts. x [M, K] row-major (s8 codes, or bf16 activations for fp8); w
// [N, K] row-major (s8 or e4m3fn), i.e. the JAX package's [K, N] weight
// held K-contiguous (quant.api.to_kernel_layout); x_scale (int8) f32, one
// per row (stride 1) or one for all (stride 0); w_scale f32, one per column
// or one for all; optional bias [N] in the output type; out [M, N] bf16 or
// f32, row-major.
//   int8: out = cast(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs[m]), ws[n]))
//         acc = sum_k x[m, k] * w[n, k], exact in int32 (|acc| <= 127^2 K)
//   fp8:  out = cast(__fmul_rn(acc, ws[n])), acc = sum_k x[m, k] * w[n, k]
//         in f32; every e4m3fn value is exact in bf16 and every bf16 x e4m3
//         product exact in f32, so the f32 sums (tensor-core order) are the
//         only roundings before the scale
//   then, with a bias, cast(f32(out) + f32(bias[n])): quantized_linear's
//   epilogue, which rounds the product to the output type before the bias.
// The casts round to nearest even; no two of these operations are
// contracted into an FMA. Requires K % 16 == 0 and N % 8 == 0 (the tensor
// maps' 16-byte row strides). The e4m3 NaN codes (0x7f, 0xff), which the
// quantizer never writes, widen to +-480.
//
// Bound on an H100 SXM: operations. 2*M*N*K operations at 1979 TOP/s (int8)
// or 989 TFLOP/s (bf16) against the operands read and the output written
// once at 3.35 TB/s. One layer's six linears at M = 4680 are 390.1 G
// operations: 0.1971 ms in int8, 0.3944 ms in bf16, against ~0.11 ms of
// bytes. Only wgmma reaches the tensor cores' rate on this card.
//
// Design: one persistent, warp-specialised kernel for both: a CTA of one
// producer warpgroup and two consumer warpgroups (384 threads), one CTA an
// SM, wgmma fed by TMA.
//   - The tile: 128 rows of the rows operand (64 a consumer warpgroup) x kBN
//     columns, kBN 256, 224 or 128 by the launcher's plan (make_plan): the
//     width whose rounds of tiles over the SMs cost the least, a tile
//     costing its width plus kTileCost columns of fixed work. That is how
//     the partial last wave is handled: the N = 1536 linears have 222 int8
//     tiles of 256, two rounds on 132 SMs, the second 68% full, or 259 of
//     224, two rounds of a narrower tile, 96% full. A k-stage is 128 bytes
//     of k: 128 int8 codes or 64 bf16 values, four wgmma k-steps.
//   - B3 (int8): the product x . W^T, rows tokens, both operands through
//     shared-memory descriptors (K-major, 128-byte swizzle): m64nNk32 s8.
//   - B8 (fp8): the transposed product W . x^T, rows channels. The raw
//     e4m3 tile (128 rows x 64 bytes, TMA's 64-byte swizzle) is widened in
//     the consumers' registers into wgmma's A fragments, x (bf16, 128-byte
//     swizzle) is the B operand: m64nNk16 bf16 with A from registers. Two
//     fragment buffers: stage k + 1 is widened
//     into the buffer the group of stage k - 1 read, after the wait that
//     retired it, while stage k's wgmmas run; ptxas serialises no wgmma
//     (no C75xx warning). The widening is integer work: each e4m3 byte put
//     in a bf16's bit places (sign to bit 15, the 7 exponent and mantissa
//     bits to bits 10..4) is the value times 2^-120 exactly, subnormals
//     included, and one bf16 multiply by 2^120 restores it exactly.
//     Widening into a bf16 B tile in shared memory instead (the product
//     x . W^T, both operands through descriptors) ran 1.7-1.9x slower: the
//     widening's shared-memory traffic on top of wgmma's own.
//   - The tile walk: CTA c takes tiles c, c + grid, ... in a grouped order
//     (8 row tiles by all column tiles a group), so the CTAs in flight
//     share operands in L2.
//   - The producer warpgroup gives up registers (setmaxnreg.dec to 40); one
//     thread keeps a ring of 3-5 stages full with TMA loads under full /
//     empty mbarriers, running ahead across tiles, so a tile's epilogue
//     overlaps the next tile's loads. TMA zero-fills rows past M and N and
//     k past K: no padding copies, no size switch (M = 1 ... 9360, K = 16).
//   - The consumers raise theirs (setmaxnreg.inc to 232). Each k-stage: an
//     explicit wgmma.fence (without it ptxas injects warpgroup arrives in a
//     divergent path and serialises the wgmmas), four wgmmas, commit, then
//     wgmma.wait_group 1: one group stays in flight, and the stage of the
//     group before, now retired, is released to the producer.
//   - The epilogue scales and rounds in registers, writes the tile into the
//     warpgroup's staging slots in boxes of 64 (32 for fp8) tokens x 64
//     bytes (the 64-byte swizzle: conflict-free stores; fp8's bf16
//     through stmatrix.trans, a token's 8 channels a row), and one thread
//     stores each box with a TMA store, clipped at M and N. What it costs
//     is conversions (one F2FP a pair of values and rounding) and, for B3,
//     the per-column scales and biases, loaded a round ahead through the
//     read-only path.
//   - No __trap() anywhere: a wait that never ends stores to address 0
//     after 2^22 polls (~15 s), so the launch fails instead of hanging the
//     card, and no block is shared by the two roles (a shared trap block
//     pins both at the launch's 168 registers and serialises every wgmma).
//   - Shared-memory pointers are offsets from the __shared__ array, never
//     through uintptr_t (which turns shared accesses into generic ones).
//
// C interface: raw pointers, the stream; the launchers build the tensor maps
// (cuTensorMapEncodeTiled, from the driver through cudaGetDriverEntryPoint:
// no -lcuda), allocate nothing, do not synchronise, and return a CUDA error
// code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kBM = 128;                 // rows a tile: 64 a consumer warpgroup
constexpr int kRowBytes = 128;           // k bytes a stage: one 128-byte swizzle row
constexpr int kThreads = 384;            // 2 consumer warpgroups + the producer's
constexpr int kLaunchRegs = 168;         // 65536 / 384, rounded down to 8
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// setmaxnreg trades within the CTA's launch allocation: an .inc that asks for
// more than the .dec freed waits forever
static_assert((kConsumerRegs - kLaunchRegs) * 256 <= (kLaunchRegs - kProducerRegs) * 128,
              "consumer budget over what the producer frees");
constexpr int kMaxSmem = 232448;
constexpr int kBarBytes = 256;
constexpr int kMaxStages = 5;
constexpr int kOutBytes = 32768;         // output staging, 16 KB a consumer warpgroup
constexpr int kGroupM = 8;               // row tiles a group of the tile walk
// A tile's fixed work in columns of the plan's cost: ~3.2 us a 128 x 224
// fp8 tile at K 1536, where a column costs ~0.068 us (H100 SXM).
constexpr int kTileCost = 48;

// The kernel's two kinds: int8 (kFp8 false: the product x . W^T, both s8
// operands through descriptors) and fp8 (the transposed product W . x^T, the
// widened weight wgmma's register A operand, x its B operand).
template <bool kFp8, int kBN>
struct Cfg {
  // a stage: the rows operand (128 rows: x, or fp8's raw e4m3 weight of 64
  // k), then the columns operand (kBN rows x 128 bytes)
  static constexpr int kABytes = kBM * (kFp8 ? 64 : kRowBytes);
  static constexpr int kBBytes = kBN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kFit = (kMaxSmem - kBarBytes - 1024 - kOutBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kBarBytes + 1024 + kStages * kStageBytes + kOutBytes;
  static constexpr int kK = kFp8 ? 64 : 128;               // k a stage
  // output boxes: 64 rows (tokens) x 64 bytes, or 32 for fp8, whose tiles
  // of 224 tokens hold 7 of them
  static constexpr int kBoxRows = kFp8 ? 32 : 64;
  static constexpr int kBoxBytes = kBoxRows * 64;
  static constexpr int kSlots = kOutBytes / 2 / kBoxBytes;  // a consumer warpgroup
  static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0 && kBBytes % 1024 == 0,
                "tiles keep the swizzle's 1024-byte phase");
  static_assert(kStages >= 3, "a ring of at least 3 stages");
  static_assert(kSmem <= kMaxSmem, "shared memory over the H100's 227 KB");
  static_assert(2 * kMaxStages * 8 <= kBarBytes, "mbarriers");
};

struct Params {
  const float* xs;       // int8: activation scales, xs[m * xs_stride]
  const float* ws;       // weight scales, ws[n * ws_stride]
  const void* bias;      // [N] in the output type, or null
  int xs_stride, ws_stride;
  int M, N, K;
  int tiles_r, tiles_c, n_tiles;   // row tiles (of the rows operand), column tiles
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
// never ends (a lost arrival) stores to address 0 after 2^22 polls (~15 s),
// so the launch fails (an illegal address) instead of hanging the card.
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
    if (n == (1u << 22)) asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0u) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk stores committed so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Four 8 x 8 b16 matrices of the accumulator fragment layout (thread g, t4
// holds row g, columns 2 t4 and 2 t4 + 1 of each, in r0..r3), stored
// transposed: lane 8 m + j gives the address of matrix m's column j, whose
// eight values land there contiguous (16 bytes).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused, the
// base-offset field 0 (the tiles start at 1024-byte multiples).
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program: asm volatile statements keep
// their order, so reads of r stay after a wgmma wait.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

// D[64 x N] += A[64 x 32] * B[32 x N], s8 through shared-memory descriptors
// (K-major, 128-byte swizzle), int32 sums.
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], uint64_t da, uint64_t db);

// D[64 x N] += A[64 x 16] (registers, bf16 fragments) * B[16 x N] (shared
// memory descriptor, K-major, 128-byte swizzle), f32 sums.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<256>(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<224>(int (&d)[112], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
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
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Four e4m3 bytes (k order, the first in the low byte) -> four bf16 (two
// bf16x2 words, the first value in the low half of .x), exactly: the sign to
// bit 15 and the exponent and mantissa bits to bits 10..4 of each bf16 give
// the e4m3 value times 2^-120 (subnormals too: both formats scale a zero
// exponent field the same way), and a bf16 multiply by 2^120 is exact.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t mag = w & 0x7f7f7f7fu;
  const uint32_t lo = (__byte_perm(mag, 0u, 0x4140u) << 4) |
                      (__byte_perm(w, 0u, 0x1404u) & 0x80008000u);
  const uint32_t hi = (__byte_perm(mag, 0u, 0x4342u) << 4) |
                      (__byte_perm(w, 0u, 0x3424u) & 0x80008000u);
  const __nv_bfloat162 k = __halves2bfloat162(__ushort_as_bfloat16(0x7B80u),
                                              __ushort_as_bfloat16(0x7B80u));  // 2^120
  __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&lo);
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  a = __hmul2(a, k);
  b = __hmul2(b, k);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// The A fragment bytes of thread t4 of a quad in row `row` of the raw
// weight tile (64-byte rows, TMA's 64-byte swizzle: 16-byte chunk c of row r
// at chunk c ^ ((r >> 1) & 3)), k16 step kk: k = 16 kk + (2 t4, 2 t4 + 1,
// 8 + 2 t4, 9 + 2 t4), gathered from two 4-byte words by one byte_perm.
__device__ __forceinline__ uint32_t gather4(const uint8_t* tile, int row, int kk, int t4) {
  const uint8_t* chunk = tile + row * 64 + ((kk ^ ((row >> 1) & 3)) << 4);
  const uint32_t a = *reinterpret_cast<const uint32_t*>(chunk + 4 * (t4 >> 1));
  const uint32_t b = *reinterpret_cast<const uint32_t*>(chunk + 8 + 4 * (t4 >> 1));
  return __byte_perm(a, b, (t4 & 1) ? 0x7632u : 0x5410u);
}

// The bf16 A fragments of one stage (four k16 steps) for rows
// `row` and `row` + 8 of the raw weight tile.
__device__ __forceinline__ void widen_fragments(uint32_t (&a)[4][4], const uint8_t* tile, int row,
                                                int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint2 lo = widen4(gather4(tile, row, kk, t4));
    const uint2 hi = widen4(gather4(tile, row + 8, kk, t4));
    a[kk][0] = lo.x;
    a[kk][1] = hi.x;
    a[kk][2] = lo.y;
    a[kk][3] = hi.y;
  }
}

__device__ __forceinline__ float scale_acc(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}
__device__ __forceinline__ float scale_acc(float acc, float, float ws) {
  return __fmul_rn(acc, ws);
}

// Two values as stored, in bf16: each rounded once, then (with a bias) the
// bias added in f32 and rounded again; a pair a conversion (F2FP), not one
// a value (the conversions bound the epilogue).
__device__ __forceinline__ uint32_t finish2(float v0, float v1, float b0, float b1, bool bias) {
  __nv_bfloat162 q = __floats2bfloat162_rn(v0, v1);
  if (bias) {
    const float2 f = __bfloat1622float2(q);
    q = __floats2bfloat162_rn(__fadd_rn(f.x, b0), __fadd_rn(f.y, b1));
  }
  return *reinterpret_cast<const uint32_t*>(&q);
}

// Two adjacent columns of one row; in f32 the product itself, plus the
// bias rounded once.
template <bool kOutF32>
__device__ __forceinline__ void put2(uint8_t* dst, float v0, float v1, float b0, float b1,
                                     bool bias) {
  if constexpr (kOutF32)
    *reinterpret_cast<float2*>(dst) =
        bias ? make_float2(__fadd_rn(v0, b0), __fadd_rn(v1, b1)) : make_float2(v0, v1);
  else
    *reinterpret_cast<uint32_t*>(dst) = finish2(v0, v1, b0, b1, bias);
}

// Scales and bias through the read-only path (ld.global.nc): not ordered
// behind the epilogue's shared-memory stores, so they are issued ahead.
template <bool kOutF32>
__device__ __forceinline__ float bias_at(const Params& p, int n) {
  if constexpr (kOutF32) return __ldg(static_cast<const float*>(p.bias) + n);
  return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p.bias) + n));
}

// Tile -> its origin (r0, c0) in rows of the rows operand and of the
// columns operand: groups of kGroupM row tiles by all column tiles,
// column-major within a group.
template <int kBN>
__device__ __forceinline__ void tile_origin(const Params& p, int tile, int& r0, int& c0) {
  const int per_group = kGroupM * p.tiles_c;
  const int group = tile / per_group, first = group * kGroupM;
  const int rows = min(p.tiles_r - first, kGroupM);
  const int in_group = tile - group * per_group;
  r0 = (first + in_group % rows) * kBM;
  c0 = (in_group / rows) * kBN;
}

// Byte offset of (row, byte) in an output box of 64-byte rows with the
// 64-byte swizzle (16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)).
__device__ __forceinline__ int box_offset(int row, int byte) {
  return row * 64 + (((byte >> 4) ^ ((row >> 1) & 3)) << 4) + (byte & 15);
}

template <bool kFp8, bool kOutF32, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_out, const Params p) {
  using C = Cfg<kFp8, kBN>;
  using Acc = typename std::conditional<kFp8, float, int>::type;
  constexpr int S = C::kStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // TMA bytes landed
  uint64_t* empty = full + kMaxStages;                      // stage consumed
  // 1024-aligned, as an offset from smem_raw (the swizzle's phase)
  uint8_t* ring = smem_raw + kBarBytes + ((0u - smem_u32(smem_raw) - kBarBytes) & 1023u);
  uint8_t* out_stage = ring + S * C::kStageBytes;            // 2 x kSlots boxes

  const int tid = threadIdx.x;
  const int nk = (p.K + C::kK - 1) / C::kK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 256) {
      // one thread keeps the ring full, across tiles
      int s = 0;
      uint32_t ph = 0, it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        int r0, c0;
        tile_origin<kBN>(p, tile, r0, c0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (it >= S) mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * C::kStageBytes;
          mbar_expect_tx(&full[s], C::kStageBytes);
          tma_load_2d(st, &tm_a, &full[s], kt * C::kK, r0);
          tma_load_2d(st + C::kABytes, &tm_b, &full[s], kt * C::kK, c0);
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows of the rows operand each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t ring_u32 = smem_u32(ring);
    uint8_t* my_out = out_stage + wg * C::kSlots * C::kBoxBytes;
    const bool leader = (tid & 127) == 0;
    constexpr int kEl = kOutF32 ? 4 : 2;
    constexpr int kBoxCols = 64 / kEl;          // 32 bf16 or 16 f32 columns a box
    Acc acc[kBN / 2];
    uint32_t afr[2][4][4];                      // fp8: two stages' A fragments
    int s = 0, pend = -1;
    uint32_t ph = 0;
    auto advance = [&]() {
      wgmma_wait<1>();  // the stage before is read: release it
      if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
      pend = s;
      if (++s == S) { s = 0; ph ^= 1; }
    };

    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      int r0, c0;
      tile_origin<kBN>(p, tile, r0, c0);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
      if constexpr (kFp8) {
        // The A fragments of stage k + 1 are widened while the wgmmas of
        // stage k run; they land in the other buffer, which the group of
        // stage k - 1 (retired by the wait before) read.
        const int row = 64 * wg + 16 * warp + g;
        mbar_wait(&full[s], ph);
        widen_fragments(afr[0], ring + s * C::kStageBytes, row, t4);
        for (int kt = 0; kt < nk; kt += 2) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && kt + 1 >= nk) break;
            const uint32_t b = ring_u32 + s * C::kStageBytes + C::kABytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<kBN>(acc, afr[u][kk], sw128_desc(b + 32 * kk));
            wgmma_commit();
            advance();
            if (kt + u + 1 < nk) {
              mbar_wait(&full[s], ph);
              widen_fragments(afr[u ^ 1], ring + s * C::kStageBytes, row, t4);
            }
          }
        }
      } else {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&full[s], ph);
          const uint32_t a = ring_u32 + s * C::kStageBytes + wg * 64 * kRowBytes;
          const uint32_t b = ring_u32 + s * C::kStageBytes + C::kABytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<kBN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
          wgmma_commit();
          advance();
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
      pend = -1;

      // Epilogue. Fragment: acc[4 i + 2 h + e] is row 16 warp + g + 8 h of
      // this warpgroup's 64 rows, column 8 i + 2 t4 + e of the tile. Boxes
      // of kBoxRows tokens x kBoxCols channels go through the warpgroup's
      // kSlots staging slots, a round at a time, each stored by TMA.
      const int rw = r0 + 64 * wg;               // this warpgroup's first row
      const int r = 16 * warp + g;
      const bool bias = p.bias != nullptr;
      if constexpr (kFp8) {
        // rows are channels, columns tokens: a token box holds 32 tokens of
        // 64 / kBoxCols channel boxes
        constexpr int kPerTb = 64 / kBoxCols;
        constexpr int kTbRound = C::kSlots / kPerTb;
        constexpr int kTbs = kBN / 32;
        float w[2], bb[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = min(rw + r + 8 * h, p.N - 1);
          w[h] = __ldg(p.ws + static_cast<long long>(n) * p.ws_stride);
          if (bias) bb[h] = bias_at<kOutF32>(p, n);
        }
#pragma unroll
        for (int tb0 = 0; tb0 < kTbs; tb0 += kTbRound) {
          if (leader) bulk_wait_read();  // the slots' last stores have read them
          bar_sync(1 + wg, 128);
#pragma unroll
          for (int t = 0; t < kTbRound; ++t) {
            if (tb0 + t < kTbs) {
              if constexpr (!kOutF32) {
                // two n8 blocks (16 tokens) x this warp's 16 channels a
                // stmatrix: matrix m is block 2 jj + (m >> 1), channel half m & 1
                const int m = lane >> 3;
                const uint32_t slot = smem_u32(my_out) + (t * kPerTb + (warp >> 1)) * C::kBoxBytes;
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                  const int i = (tb0 + t) * 4 + 2 * jj;
                  uint32_t q[4];
#pragma unroll
                  for (int mm = 0; mm < 4; ++mm) {
                    const int a = 4 * (i + (mm >> 1)) + 2 * (mm & 1), h = mm & 1;
                    q[mm] = finish2(scale_acc(acc[a], 1.f, w[h]), scale_acc(acc[a + 1], 1.f, w[h]),
                                    bb[h], bb[h], bias);
                  }
                  const int tok = 8 * (2 * jj + (m >> 1)) + (lane & 7);
                  stmatrix_x4_trans(slot + box_offset(tok, ((warp & 1) * 2 + (m & 1)) * 16), q[0],
                                    q[1], q[2], q[3]);
                }
              } else {
#pragma unroll
                for (int ii = 0; ii < 4; ++ii) {
                  const int i = (tb0 + t) * 4 + ii;
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int ch = r + 8 * h;
                    uint8_t* slot = my_out + (t * kPerTb + ch / kBoxCols) * C::kBoxBytes;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      const float v = scale_acc(acc[4 * i + 2 * h + e], 1.f, w[h]);
                      *reinterpret_cast<float*>(slot + box_offset(8 * ii + 2 * t4 + e,
                                                                  (ch % kBoxCols) * kEl)) =
                          bias ? __fadd_rn(v, bb[h]) : v;
                    }
                  }
                }
              }
            }
          }
          fence_proxy_async();  // the async proxy (TMA) reads what was written
          bar_sync(1 + wg, 128);
          if (leader) {
#pragma unroll
            for (int t = 0; t < kTbRound; ++t) {
              const int tok = c0 + (tb0 + t) * 32;
#pragma unroll
              for (int cb = 0; cb < kPerTb; ++cb) {
                const int ch = rw + cb * kBoxCols;
                if (tb0 + t < kTbs && tok < p.M && ch < p.N)
                  tma_store_2d(&tm_out, my_out + (t * kPerTb + cb) * C::kBoxBytes, ch, tok);
              }
            }
            bulk_commit();
          }
        }
      } else {
        // rows are tokens, columns channels
        constexpr int kBoxes = kBN / kBoxCols;
        constexpr int kBlocks = kBoxCols / 8;      // n8 blocks of the fragment a box
        float xs[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xs[h] = __ldg(p.xs + static_cast<long long>(min(rw + r + 8 * h, p.M - 1)) * p.xs_stride);
#pragma unroll
        for (int b0 = 0; b0 < kBoxes; b0 += C::kSlots) {
          // the round's column scales and biases first, all loads in
          // flight together (one at a time, their latency was a third of
          // the int8 kernel's time at K 1536)
          float w[C::kSlots][kBlocks][2], bb[C::kSlots][kBlocks][2];
#pragma unroll
          for (int sb = 0; sb < C::kSlots; ++sb)
#pragma unroll
            for (int ii = 0; ii < kBlocks; ++ii)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = min(c0 + 8 * ((b0 + sb) * kBlocks + ii) + 2 * t4 + e, p.N - 1);
                w[sb][ii][e] = b0 + sb < kBoxes
                                   ? __ldg(p.ws + static_cast<long long>(n) * p.ws_stride) : 0.f;
                bb[sb][ii][e] = b0 + sb < kBoxes && bias ? bias_at<kOutF32>(p, n) : 0.f;
              }
          if (leader) bulk_wait_read();  // the slots' last stores have read them
          bar_sync(1 + wg, 128);
#pragma unroll
          for (int sb = 0; sb < C::kSlots; ++sb) {
            if (b0 + sb < kBoxes) {
              uint8_t* box = my_out + sb * C::kBoxBytes;
#pragma unroll
              for (int ii = 0; ii < kBlocks; ++ii) {
                const int i = (b0 + sb) * kBlocks + ii;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  put2<kOutF32>(box + box_offset(r + 8 * h, (8 * ii + 2 * t4) * kEl),
                                scale_acc(acc[4 * i + 2 * h], xs[h], w[sb][ii][0]),
                                scale_acc(acc[4 * i + 2 * h + 1], xs[h], w[sb][ii][1]),
                                bb[sb][ii][0], bb[sb][ii][1], bias);
              }
            }
          }
          fence_proxy_async();  // the async proxy (TMA) reads what was written
          bar_sync(1 + wg, 128);
          if (leader) {
#pragma unroll
            for (int sb = 0; sb < C::kSlots; ++sb) {
              const int col = c0 + (b0 + sb) * kBoxCols;
              if (b0 + sb < kBoxes && col < p.N && rw < p.M)
                tma_store_2d(&tm_out, my_out + sb * C::kBoxBytes, col, rw);
            }
            bulk_commit();
          }
        }
      }
    }
    if (leader) bulk_wait();  // stores done before the CTA's shared memory goes
  }
}

// ---- host side ----

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
// box = box_rows x box_cols; what lies outside reads as zeros and is not
// written.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
               uint64_t rows, uint64_t pitch, uint32_t box_cols, uint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// The tile plan over an [R, C] product (R the rows operand's rows: tokens,
// or channels for fp8; C the columns operand's): the width (256, 224 or
// 128 columns) whose rounds of tiles over the SMs cost the least, a tile
// costing its width plus kTileCost columns (its fixed work: the pipeline's
// start, the epilogue), the wider on a tie; the grid.
struct Plan {
  int bn, tiles_r, tiles_c, n_tiles, grid;
};

Plan make_plan(int R, int C, int sms) {
  Plan best{0, 0, 0, 0, 0};
  long long best_cost = 0;
  for (int bn : {256, 224, 128}) {
    const long long tr = (R + kBM - 1) / kBM, tc = (C + bn - 1) / bn;
    const long long tiles = tr * tc;
    const long long cost = (tiles + sms - 1) / sms * (bn + kTileCost);
    if (tiles > 0x7fffffffLL) continue;
    if (best.bn == 0 || cost < best_cost) {
      best_cost = cost;
      best = Plan{bn, static_cast<int>(tr), static_cast<int>(tc), static_cast<int>(tiles),
                  static_cast<int>(tiles < sms ? tiles : sms)};
    }
  }
  return best;
}

// The plan of an [M, K] x [K, N] product of the given kind.
Plan plan_of(bool fp8, int M, int N, int sms) {
  return fp8 ? make_plan(N, M, sms) : make_plan(M, N, sms);
}

template <bool kFp8, bool kOutF32, int kBN>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& to,
                   const Params& p, int grid, cudaStream_t stream) {
  using C = Cfg<kFp8, kBN>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<kFp8, kOutF32, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  gemm_sm90_kernel<kFp8, kOutF32, kBN><<<grid, kThreads, C::kSmem, stream>>>(ta, tb, to, p);
  return cudaGetLastError();
}

template <bool kFp8, bool kOutF32>
cudaError_t launch_bn(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& to,
                      const Params& p, int bn, int grid, cudaStream_t s) {
  if (bn == 256) return launch<kFp8, kOutF32, 256>(ta, tb, to, p, grid, s);
  if (bn == 224) return launch<kFp8, kOutF32, 224>(ta, tb, to, p, grid, s);
  if (bn == 128) return launch<kFp8, kOutF32, 128>(ta, tb, to, p, grid, s);
  return cudaErrorInvalidValue;
}

template <bool kFp8>
int run(const void* x, const void* w, const void* xs, int xs_stride, const void* ws,
        int ws_stride, const void* bias, void* out, int M, int N, int K, int out_f32,
        void* stream) {
  if (K <= 0 || N <= 0 || M <= 0 || K % 16 != 0 || N % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan plan = plan_of(kFp8, M, N, sms);
  if (plan.bn == 0) return static_cast<int>(cudaErrorInvalidValue);
  // Boxes: int8 x [M, K] and w [N, K] 128 rows (bn for w) x 128 bytes, in
  // the swizzle wgmma reads; fp8 w raw 128 x 64 bytes (the 64-byte swizzle
  // its fragment gathers read conflict-free), x bf16 bn x 64 values. out
  // [M, N]: 64 (32 for fp8) rows x 64 bytes, the 64-byte swizzle.
  CUtensorMap ta, tb, to;
  const CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok;
  if (!kFp8)
    ok = encode_2d(&ta, kU8, x, K, M, K, 128, kBM, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_2d(&tb, kU8, w, K, N, K, 128, plan.bn, CU_TENSOR_MAP_SWIZZLE_128B);
  else
    ok = encode_2d(&ta, kU8, w, K, N, K, 64, kBM, CU_TENSOR_MAP_SWIZZLE_64B) &&
         encode_2d(&tb, kBf16, x, K, M, 2ull * K, 64, plan.bn, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint32_t box_rows = Cfg<kFp8, 256>::kBoxRows;
  ok = ok && (out_f32 ? encode_2d(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, N, M, 4ull * N, 16,
                                  box_rows, CU_TENSOR_MAP_SWIZZLE_64B)
                      : encode_2d(&to, kBf16, out, N, M, 2ull * N, 32, box_rows,
                                  CU_TENSOR_MAP_SWIZZLE_64B));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = bias;
  p.xs_stride = xs_stride;
  p.ws_stride = ws_stride;
  p.M = M;
  p.N = N;
  p.K = K;
  p.tiles_r = plan.tiles_r;
  p.tiles_c = plan.tiles_c;
  p.n_tiles = plan.n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch_bn<kFp8, true>(ta, tb, to, p, plan.bn, plan.grid, s)
                                  : launch_bn<kFp8, false>(ta, tb, to, p, plan.bn, plan.grid, s));
}

}  // namespace

// x [M, K] s8, w [N, K] s8, x_scale / w_scale f32 with strides 1 or 0.
extern "C" int inferix_int8_matmul(const void* x, const void* w, const void* xs, int xs_stride,
                                   const void* ws, int ws_stride, const void* bias, void* out,
                                   int M, int N, int K, int out_f32, void* stream) {
  return run<false>(x, w, xs, xs_stride, ws, ws_stride, bias, out, M, N, K, out_f32, stream);
}

// x [M, K] bf16, w [N, K] e4m3fn, w_scale f32 with stride 1 or 0.
extern "C" int inferix_fp8_matmul(const void* x, const void* w, const void* ws, int ws_stride,
                                  const void* bias, void* out, int M, int N, int K, int out_f32,
                                  void* stream) {
  return run<true>(x, w, nullptr, 0, ws, ws_stride, bias, out, M, N, K, out_f32, stream);
}

// The tile plan of the int8 (fp8 = 0) or the fp8 (fp8 = 1) launcher for
// [M, K] x [K, N] on `sms` SMs: plan[0..2] = tile width, tiles, CTAs.
// Returns 0, or cudaErrorInvalidValue.
extern "C" int inferix_gemm_plan(int M, int N, int fp8, int sms, int* plan) {
  if (M <= 0 || N <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_of(fp8 != 0, M, N, sms);
  plan[0] = p.bn;
  plan[1] = p.n_tiles;
  plan[2] = p.grid;
  return p.bn == 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
