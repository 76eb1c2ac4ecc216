// Stride-1 3x3(xkt) convolution for NVIDIA Hopper (sm_90a), the VAE decode's
// hot convs in bf16 and in W8A8, on warpgroup MMA (wgmma) fed by TMA under
// mbarriers; and the W8A8 conv's per-tensor activation quantization as one
// fused pair of passes.
//
// Replaces two TPU kernels of inferix_tpu/ops/halo_conv.py, and the XLA
// chain of the second's wrapper:
//   `_halo_conv_kernel` (body :59, pallas_call :270, wrapper halo_conv3d
//   :225): bf16 operands, f32 accumulation, + bias in f32;
//   `_halo_conv_kernel_i8` (body :113, pallas_call :200, wrapper
//   halo_conv3d_w8a8 :161): int8 codes, exact int32 sums, then
//   f32(acc) * sv + b in f32 (sv = s_x * s_w per output channel);
//   the activation quantization of that wrapper (:183-185), there fused by
//   XLA into a reduction and one quantizing pass.
//
// Conv contract:
//   x [Tin, H, W, Cin] bf16 or s8 codes, contiguous, 16-byte aligned, Cin a
//   multiple of 8 (bf16) or 16 (s8): rows of 16-byte multiples, as TMA
//   wants them;
//   w [kt, 9, Cout, Cin] bf16 or s8 (tap (dh, dw) as 3 dh + dw; each output
//   channel's Cin values contiguous), 16-byte aligned;
//   bias [Cout] f32; W8A8 only: s_x (one f32 on the device) and s_w [Cout] f32;
//   out [Tout, H, W, Cout] bf16, Tout = Tin - kt + 1.
// Temporal VALID (the causal caller prepends kt - 1 frames), spatial SAME
// (zeros at the border), stride 1.
//   bf16: out = bf16(__fadd_rn(sum_taps,c x*w (f32), bias))
//   W8A8: out = bf16(__fadd_rn(__fmul_rn(__int2float_rn(acc),
//                                        __fmul_rn(s_x, s_w[n])), bias)),
//         the JAX order `acc.astype(f32) * (s_x * s_w) + b` with no FMA
//         contraction; the sums are exact (|acc| < 127^2 * 27 * 384 < 2^31).
//
// Bound on an H100 SXM: 2*Tout*H*W*Cout*kt*9*Cin operations at 989 TFLOP/s
// (bf16) or 1979 TOP/s (int8), against the input, weights and output read
// or written once at 3.35 TB/s. The decode's hottest class, [14, 480, 832,
// 96] 3x3x3 96 -> 96, is 2.39 TFLOP -> 2.41 ms in bf16 (1.21 ms in int8)
// against 0.60 ms of bytes: the convs are bound by operations, the RGB head
// (96 -> 3) by bytes.
//
// Design. An implicit GEMM, M = output pixels, N = output channels, K =
// taps x Cin, on a persistent grid (one CTA an SM, each walking tiles
// blockIdx.x, + gridDim.x, ...) of 1 producer warp and kWG (2 or 3)
// consumer warpgroups.
//   - The tile. 8*kWG output rows x 16 columns of one frame (256 or 384
//     pixels) by kN output channels: 96 (Cout 96, and 192 or 384 in 2 or 4
//     tiles) or 8 (the head's Cout 3; wgmma's N may be 8). The pixels form
//     m64 blocks of 8 x 8, two a consumer warpgroup. Tiles are ordered
//     channel tile fastest, then frame, then space, so the CTAs in flight
//     share their halos and weights in L2.
//   - The halo: one TMA box a stage (dt, 128-byte channel chunk: 64 bf16 or
//     128 s8), (8*kWG + 2) rows x 18 columns x 128 bytes from (h0 - 1,
//     w0 - 1), in the 128-byte swizzle. TMA zero-fills what lies outside x:
//     the SAME border and the channels past Cin (Cin 16, 96) cost no code.
//   - Nine taps read the one halo, both wgmma operands from shared memory:
//     the A operand of tap (dh, dw) for an 8 x 8 block is the halo window
//     shifted by (dh, dw), so its descriptor starts (dh * 18 + dw) * 128
//     bytes further, and its 8-row groups (the block's rows) lie one halo
//     row, 18 * 128 bytes, apart (the descriptor's SBO). wgmma applies the
//     128-byte swizzle to absolute shared-memory address bits, as TMA wrote
//     it, so a start at any 128-byte multiple reads the right bytes with the
//     base-offset field left 0 (set to the start's phase it reads wrong
//     ones: measured). wgmma m64nNk16 (bf16, f32 sums) or m64nNk32 (s8,
//     s32 sums); k-steps past Cin are skipped.
//     Tried first: A in registers, loaded per lane by ldmatrix from the same
//     halo. ptxas serialises every wgmma of that form (C7513: registers a
//     wgmma reads are written while another is in flight), which held the
//     kernel at 37-43% of the bf16 rate.
//   - The weights: one TMA box per (stage, tap), kN rows (output channels)
//     x 128 bytes, K-major in the 128-byte swizzle: wgmma's B operand. Rows
//     past Cout are zero-filled by TMA.
//   - The pipeline. Rings of 2 halos (3 for the head, bound by its halo
//     bytes) and 4 weight tiles (8 for the head's 1 KB ones), each slot
//     with a full (TMA bytes) and an empty (one arrival per consumer warp)
//     mbarrier; 3 and 8 weight tiles measured slower than 4. The producer
//     thread runs ahead across stages and tiles. A consumer warpgroup issues
//     a tap's wgmmas (up to 4 k-steps x 2 blocks) behind an explicit
//     wgmma.fence (without it ptxas injects warpgroup arrives in a divergent
//     path and serialises them, C7520), commits, and waits until only that
//     group is in flight, which frees the slots of the tap before.
//   - The epilogue (N 96): each warpgroup writes an 8 x 8-pixel block's
//     bf16 outputs into its staging buffer in shared memory and one thread
//     stores it with a TMA bulk store (clipped at ragged H, W and Cout), so
//     the stores overlap the next tile's products. Stored straight from the
//     fragments instead, the epilogue took a third of the int8 kernel's
//     time. The head (Cout 3: rows of 6 bytes, which TMA cannot describe)
//     and a Cout that is not a multiple of 8 store from the fragments.
//   - Registers: no setmaxnreg. A 32-thread producer leaves the consumers
//     224 (kWG 2) or 152 (kWG 3) registers a thread at launch; they need
//     the 96 accumulators and the addressing. No __trap() anywhere: a lost
//     arrival faults with a store to address 0 after 2^22 polls.
//   - Shared-memory pointers are offsets from the __shared__ array (never
//     through uintptr_t: that turns shared accesses into generic ones).
//
// The activation quantization (W8A8): s_x = max(absmax(x), 1e-8) / 127,
// codes clamp(round_half_even(x / s_x), -127, 127), with IEEE division as
// the plain version divides (by a device scalar: a true division):
//   pass 1 reads x as bf16 in 16-byte loads, grid-stride, reduces |x| as
//     15-bit magnitudes (__vmaxu2: the order of bf16 magnitudes is that of
//     their bits) to one per CTA and combines the CTAs by atomicMax on the
//     f32 bits into a word the launcher zeroes (no host sync; the maximum
//     does not depend on the order);
//   pass 2 reads x again and writes the s8 codes, 8 a thread-step, and s_x.
// 5 bytes an element of device traffic (2 + 2 read, 1 written).
//
// C interface: raw pointers, the stream; the launchers build the tensor maps
// (cuTensorMapEncodeTiled, from the driver through cudaGetDriverEntryPoint:
// no -lcuda), allocate nothing, do not synchronise, and return a CUDA error
// code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTW = 16;               // output columns a tile (two 8-column blocks)
constexpr int kBoxW = 18;             // halo columns loaded (kTW + 2 used)
constexpr int kMW = 2;                // m64 blocks a consumer warpgroup
constexpr int kRowBytes = 128;        // a pixel's (or weight row's) bytes a stage
constexpr int kKSteps = 4;            // 32-byte k-steps in 128 bytes
constexpr int kMaxHStages = 3;        // halo ring, at most
constexpr int kMaxWStages = 8;        // weight ring, at most
constexpr int kBarBytes = 256;
constexpr int kMaxSmem = 232448;

template <bool kInt8, int kN, int kWG>
struct Cfg {
  static constexpr int kRows = 4 * kMW * kWG;                   // output rows a tile
  static constexpr int kHaloBytes = (kRows + 2) * kBoxW * kRowBytes;
  static constexpr int kHaloSlot = (kHaloBytes + 1023) / 1024 * 1024;
  // the head (N 8) is bound by its halo bytes: one more halo in flight
  static constexpr int kHStages = kN == 8 ? 3 : 2;
  static constexpr int kWBytes = kN * kRowBytes;                // a multiple of 1024
  // N 96: one m64 block's outputs (8 x 8 pixels x kN bf16) a consumer
  // warpgroup, staged for a TMA store
  static constexpr int kOutBytes = kN == 96 ? 64 * kN * 2 : 0;
  static constexpr int kFree =
      kMaxSmem - kBarBytes - 1024 - kHStages * kHaloSlot - kWG * kOutBytes;
  // 4 weight tiles in flight for N 96 (deeper rings measured slower), 8 of
  // the head's 1 KB tiles
  static constexpr int kWantW = kN == 8 ? kMaxWStages : 4;
  static constexpr int kWStages = kFree / kWBytes < kWantW ? kFree / kWBytes : kWantW;
  static constexpr int kSmem =
      kBarBytes + 1024 + kHStages * kHaloSlot + kWStages * kWBytes + kWG * kOutBytes;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;              // + the producer warp
  static constexpr int kChunk = kInt8 ? 128 : 64;               // channels a stage
  static constexpr int kStepCh = kInt8 ? 32 : 16;               // channels a k-step
  static_assert(kWBytes % 1024 == 0, "weight tiles keep the swizzle's 1024-byte phase");
  static_assert(kSmem <= kMaxSmem, "shared memory over the H100's 227 KB");
  static_assert(kWStages >= 3, "a weight ring of at least 3 tiles");
  static_assert((2 * kMaxHStages + 2 * kMaxWStages) * 8 <= kBarBytes, "mbarriers");
};

struct Params {
  const float* bias;
  const float* s_x;   // W8A8: the activation scale on the device
  const float* s_w;   // W8A8: [Cout]
  __nv_bfloat16* out;
  int Tout, H, W, Cin, Cout, kt;
  int n_cc, n_nt, tiles_w, n_tiles;
  int tma_store;      // the output map is valid (Cout * 2 a multiple of 16)
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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
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
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups `sbo` bytes apart, LBO unused, the base-offset
// field 0 (wgmma swizzles on absolute address bits: any 128-byte start).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// D[64 x N] += A[64 x k] * B[k x N], both through shared-memory descriptors
// (K-major, 128-byte swizzle); k = 16 bf16 or 32 s8.
__device__ __forceinline__ void wgmma_bf16_n8(float (&d)[4], uint64_t desc_a,
    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[48], uint64_t desc_a,
    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t desc_a,
    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t desc_a,
    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <bool kInt8, int kN>
__device__ __forceinline__ void wgmma_ss(typename std::conditional<kInt8, int, float>::type (&d)[kN / 2],
                                         uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kInt8) {
    if constexpr (kN == 96) wgmma_s8_n96(d, desc_a, desc_b); else wgmma_s8_n8(d, desc_a, desc_b);
  } else {
    if constexpr (kN == 96) wgmma_bf16_n96(d, desc_a, desc_b); else wgmma_bf16_n8(d, desc_a, desc_b);
  }
}

__device__ __forceinline__ float epilogue(float acc, float sv, float b, std::false_type) {
  return __fadd_rn(acc, b);
}
__device__ __forceinline__ float epilogue(int acc, float sv, float b, std::true_type) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), sv), b);
}

template <bool kInt8, int kN, int kWG>
__global__ void __launch_bounds__(Cfg<kInt8, kN, kWG>::kThreads, 1)
    halo_conv_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_out, const Params p) {
  using C = Cfg<kInt8, kN, kWG>;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kWarps = C::kConsumers / 32;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint64_t* h_full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* h_empty = h_full + kMaxHStages;
  uint64_t* w_full = h_empty + kMaxHStages;
  uint64_t* w_empty = w_full + kMaxWStages;
  constexpr int kHStages = C::kHStages, kWStages = C::kWStages;
  // 1024-aligned, as an offset from smem_raw (the swizzle's phase)
  uint8_t* halo = smem_raw + kBarBytes + ((0u - smem_u32(smem_raw) - kBarBytes) & 1023u);
  uint8_t* wring = halo + C::kHStages * C::kHaloSlot;
  uint8_t* ostage = wring + C::kWStages * C::kWBytes;  // kWG blocks of outputs

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&h_full[s], 1);
      mbar_init(&h_empty[s], kWarps);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_stages = p.kt * p.n_cc;
  // tile -> (channel tile, frame, spatial tile), the channel tile fastest
  auto decode = [&](int tile, int& t, int& h0, int& w0, int& n0) {
    const int nt = tile % p.n_nt;
    const int rest = tile / p.n_nt;
    t = rest % p.Tout;
    const int sp = rest / p.Tout;
    h0 = (sp / p.tiles_w) * C::kRows;
    w0 = (sp % p.tiles_w) * kTW;
    n0 = nt * kN;
  };

  if (tid >= C::kConsumers) {
    // ---- producer warp: one thread keeps both rings full ----
    if (tid == C::kConsumers) {
      uint32_t hc = 0, wc = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        int t, h0, w0, n0;
        decode(tile, t, h0, w0, n0);
        for (int s = 0; s < n_stages; ++s) {
          const int dt = s / p.n_cc, cc = s % p.n_cc;
          const int hs = hc % kHStages;
          if (hc >= kHStages) mbar_wait(&h_empty[hs], ((hc / kHStages) & 1) ^ 1);
          mbar_expect_tx(&h_full[hs], C::kHaloBytes);
          tma_load_4d(halo + hs * C::kHaloSlot, &tm_x, &h_full[hs], cc * C::kChunk, w0 - 1,
                      h0 - 1, t + dt);
          ++hc;
          for (int tap = 0; tap < 9; ++tap) {
            const int ws = wc % kWStages;
            if (wc >= kWStages) mbar_wait(&w_empty[ws], ((wc / kWStages) & 1) ^ 1);
            mbar_expect_tx(&w_full[ws], C::kWBytes);
            tma_load_3d(wring + ws * C::kWBytes, &tm_w, &w_full[ws], cc * C::kChunk, n0,
                        dt * 9 + tap);
            ++wc;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    // m64 block b = wg * kMW + j: output rows 8 (b >> 1) .. + 7, columns
    // 8 (b & 1) .. + 7 of the tile; its A operand row r = 8 rr + cc is halo
    // pixel (8 (b >> 1) + dh + rr, 8 (b & 1) + dw + cc): 8-row groups one
    // halo row (kBoxW * 128 bytes) apart, the tap's shift in the start.
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t halo_u32 = smem_u32(halo), wring_u32 = smem_u32(wring);
    constexpr uint32_t kSbo = kBoxW * kRowBytes;
    Acc acc[kMW][kN / 2];
    uint32_t hc = 0, wc = 0;

    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      int t, h0, w0, n0;
      decode(tile, t, h0, w0, n0);
#pragma unroll
      for (int j = 0; j < kMW; ++j)
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[j][i] = 0;
      wgmma_fence();
      int pend_w = -1, pend_h = -1;
      for (int s = 0; s < n_stages; ++s) {
        const int c0 = (s % p.n_cc) * C::kChunk;
        const int n_ks = min(kKSteps, (p.Cin - c0 + C::kStepCh - 1) / C::kStepCh);
        const int hs = hc % kHStages;
        mbar_wait(&h_full[hs], (hc / kHStages) & 1);
        const uint32_t hb = halo_u32 + hs * C::kHaloSlot;
        for (int tap = 0; tap < 9; ++tap) {
          const int dh = tap / 3, dw = tap - 3 * dh;
          const int ws = wc % kWStages;
          mbar_wait(&w_full[ws], (wc / kWStages) & 1);
          const uint32_t wb = wring_u32 + ws * C::kWBytes;
          // an explicit fence a tap: without it ptxas injects a warpgroup
          // arrive in a divergent path and serialises every wgmma (C7520)
          wgmma_fence();
          for (int ks = 0; ks < n_ks; ++ks) {
#pragma unroll
            for (int j = 0; j < kMW; ++j) {
              const int b = wg * kMW + j;
              const uint32_t a = hb + ((8 * (b >> 1) + dh) * kBoxW + 8 * (b & 1) + dw) * kRowBytes;
              wgmma_ss<kInt8, kN>(acc[j], sw128_desc(a + ks * 32, kSbo), sw128_desc(wb + ks * 32));
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the tap before is done: free its slots
          if (lane == 0) {
            if (pend_w >= 0) mbar_arrive(&w_empty[pend_w]);
            if (pend_h >= 0) mbar_arrive(&h_empty[pend_h]);
          }
          pend_w = ws;
          pend_h = -1;
          ++wc;
        }
        pend_h = hs;
        ++hc;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kMW; ++j) fence_regs(acc[j]);
      if (lane == 0) {
        if (pend_w >= 0) mbar_arrive(&w_empty[pend_w]);
        if (pend_h >= 0) mbar_arrive(&h_empty[pend_h]);
      }

      // Epilogue: warp w holds rows 16 w .. 16 w + 15 of each m64 block,
      // i.e. block rows 2 w (fragment row g) and 2 w + 1 (g + 8) at block
      // column g; n8 block i holds channels n0 + 8 i + 2 t4 (+ 1).
      const float sx = kInt8 ? __ldg(p.s_x) : 1.f;
      auto value = [&](int j, int e, int n) {
        const float sv = kInt8 ? __fmul_rn(sx, __ldg(p.s_w + n)) : 1.f;
        // read-only loads (ld.global.nc): not ordered behind the stores
        return epilogue(acc[j][e], sv, __ldg(p.bias + n), std::integral_constant<bool, kInt8>());
      };
      if constexpr (C::kOutBytes > 0) {
        if (p.tma_store) {
          // each block through this warpgroup's staging buffer [8 rows][8
          // columns][kN] and one TMA store (clipped at H, W and Cout)
          uint8_t* st = ostage + wg * C::kOutBytes;
          const bool leader = (tid & 127) == 0;
#pragma unroll
          for (int j = 0; j < kMW; ++j) {
            const int b = wg * kMW + j;
            if (leader) bulk_wait_read();  // the buffer's last store has read it
            bar_sync(1 + wg, 128);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              uint8_t* row = st + ((2 * warp + half) * 8 + g) * kN * 2;
#pragma unroll
              for (int i = 0; i < kN / 8; ++i) {
                const int c = 8 * i + 2 * t4, n = min(n0 + c, p.Cout - 1);
                const float v0 = value(j, 4 * i + 2 * half, n);
                const float v1 = value(j, 4 * i + 2 * half + 1, min(n + 1, p.Cout - 1));
                *reinterpret_cast<__nv_bfloat162*>(row + c * 2) = __floats2bfloat162_rn(v0, v1);
              }
            }
            fence_proxy_async();  // the async proxy (TMA) reads what was written
            bar_sync(1 + wg, 128);
            if (leader) {
              tma_store_4d(&tm_out, st, n0, w0 + 8 * (b & 1), h0 + 8 * (b >> 1), t);
              bulk_commit();
            }
          }
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < kMW; ++j) {
        const int b = wg * kMW + j;
        const int ow = w0 + 8 * (b & 1) + g;
        if (ow >= p.W) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int oh = h0 + 8 * (b >> 1) + 2 * warp + half;
          if (oh >= p.H) continue;
          __nv_bfloat16* orow =
              p.out + ((static_cast<long long>(t) * p.H + oh) * p.W + ow) * p.Cout;
#pragma unroll
          for (int i = 0; i < kN / 8; ++i) {
            const int n = n0 + 8 * i + 2 * t4;
            if (n >= p.Cout) continue;
            const float v0 = value(j, 4 * i + 2 * half, n);
            if (n + 1 < p.Cout) {
              const float v1 = value(j, 4 * i + 2 * half + 1, n + 1);
              if ((p.Cout & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
              } else {
                orow[n] = __float2bfloat16_rn(v0);
                orow[n + 1] = __float2bfloat16_rn(v1);
              }
            } else {
              orow[n] = __float2bfloat16_rn(v0);
            }
          }
        }
      }
    }
    if (C::kOutBytes > 0 && (tid & 127) == 0) bulk_wait();  // stores done before exit
  }
}

// ---- the W8A8 activation quantization ----

constexpr int kQThreads = 256;

// 8 bf16 |values| of a 16-byte load folded into m as two 15-bit magnitudes
__device__ __forceinline__ uint32_t absmax8(uint32_t m, uint4 v) {
  m = __vmaxu2(m, v.x & 0x7fff7fffu);
  m = __vmaxu2(m, v.y & 0x7fff7fffu);
  m = __vmaxu2(m, v.z & 0x7fff7fffu);
  return __vmaxu2(m, v.w & 0x7fff7fffu);
}

__global__ void __launch_bounds__(kQThreads) absmax_kernel(const uint4* x, long long n8,
                                                           unsigned* amax_bits) {
  uint32_t m = 0;
  for (long long i = blockIdx.x * static_cast<long long>(kQThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kQThreads)
    m = absmax8(m, __ldg(x + i));
  // the larger half, as f32 bits (a bf16's bits are the top half of its f32's)
  unsigned bits = max(m & 0xffffu, m >> 16) << 16;
  bits = __reduce_max_sync(0xffffffffu, bits);
  __shared__ unsigned warp_max[kQThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x < 32) {
    bits = threadIdx.x < kQThreads / 32 ? warp_max[threadIdx.x] : 0u;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) atomicMax(amax_bits, bits);
  }
}

__device__ __forceinline__ uint32_t code4(float s, uint32_t lo, uint32_t hi) {
  const float v[4] = {__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                      __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u)};
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = min(max(__float2int_rn(__fdiv_rn(v[e], s)), -127), 127);
    out |= (static_cast<uint32_t>(c) & 0xffu) << (8 * e);
  }
  return out;
}

__global__ void __launch_bounds__(kQThreads) codes_kernel(const uint4* x, uint2* q, long long n8,
                                                          const unsigned* amax_bits,
                                                          float* s_out) {
  const float s = __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-8f), 127.f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  for (long long i = blockIdx.x * static_cast<long long>(kQThreads) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * kQThreads) {
    const uint4 v = __ldg(x + i);
    q[i] = make_uint2(code4(s, v.x, v.y), code4(s, v.z, v.w));
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

// A map over `rank` dims (innermost first; byte strides of dims 1..rank-1);
// OOB elements read as zeros and are not written.
bool encode(CUtensorMap* map, const void* base, bool int8, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, bool swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            rank, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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

template <bool kInt8, int kN, int kWG>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& to,
                   const Params& p, cudaStream_t stream) {
  using C = Cfg<kInt8, kN, kWG>;
  static bool opted[kMaxDevices] = {};
  const cudaError_t err = smem_opt_in(halo_conv_sm90_kernel<kInt8, kN, kWG>, C::kSmem, opted);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = std::min(p.n_tiles, sms);
  halo_conv_sm90_kernel<kInt8, kN, kWG><<<grid, C::kThreads, C::kSmem, stream>>>(tx, tw, to, p);
  return cudaGetLastError();
}

template <bool kInt8>
cudaError_t launch_cfg(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& to,
                       const Params& p, int n_tile, int wgs, cudaStream_t s) {
  if (n_tile == 96 && wgs == 2) return launch<kInt8, 96, 2>(tx, tw, to, p, s);
  if (n_tile == 96 && wgs == 3) return launch<kInt8, 96, 3>(tx, tw, to, p, s);
  if (n_tile == 8 && wgs == 2) return launch<kInt8, 8, 2>(tx, tw, to, p, s);
  if (n_tile == 8 && wgs == 3) return launch<kInt8, 8, 3>(tx, tw, to, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// int8 = 0: bf16 x and w, s_x and s_w ignored; int8 = 1: s8 codes, s_x one
// f32 on the device, s_w [Cout] f32. The tile plan: n_tile output channels
// (96 or 8) by 8 * wgs rows (wgs consumer warpgroups, 2 or 3) x 16 columns.
extern "C" int inferix_halo_conv3d(const void* x, const void* w, const void* bias,
                                   const void* s_x, const void* s_w, void* out, int Tin,
                                   int H, int W, int Cin, int Cout, int kt, int n_tile,
                                   int wgs, int int8, void* stream) {
  const int esz = int8 ? 1 : 2;
  const int Tout = Tin - kt + 1;
  if ((Cin * esz) % 16 != 0 || Cin <= 0 || Tout <= 0 || H <= 0 || W <= 0 || Cout <= 0 ||
      kt <= 0 || (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (int8 && (s_x == nullptr || s_w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = int8 ? 128 : 64;
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.s_x = static_cast<const float*>(s_x);
  p.s_w = static_cast<const float*>(s_w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Tout = Tout; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.kt = kt;
  p.n_cc = (Cin + chunk - 1) / chunk;
  p.n_nt = (Cout + n_tile - 1) / n_tile;
  p.tiles_w = (W + kTW - 1) / kTW;
  const int rows = 8 * wgs;
  const long long tiles =
      static_cast<long long>((H + rows - 1) / rows) * p.tiles_w * Tout * p.n_nt;
  if (tiles > 0x7fffffffLL || rows + 2 > 256) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(tiles);
  // x [Tin, H, W, Cin]: a box of (8 wgs + 2) rows x 18 columns x 128 bytes
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(Tin)};
  const cuuint64_t xs[3] = {static_cast<cuuint64_t>(Cin) * esz,
                            static_cast<cuuint64_t>(W) * Cin * esz,
                            static_cast<cuuint64_t>(H) * W * Cin * esz};
  const cuuint32_t xb[4] = {static_cast<cuuint32_t>(chunk), kBoxW,
                            static_cast<cuuint32_t>(rows + 2), 1};
  // w [kt * 9, Cout, Cin]: a box of n_tile rows x 128 bytes
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout),
                            static_cast<cuuint64_t>(kt) * 9};
  const cuuint64_t wsd[2] = {static_cast<cuuint64_t>(Cin) * esz,
                             static_cast<cuuint64_t>(Cout) * Cin * esz};
  const cuuint32_t wbx[3] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(n_tile), 1};
  CUtensorMap tx, tw, to;
  if (!encode(&tx, x, int8, 4, xd, xs, xb, true) ||
      !encode(&tw, w, int8, 3, wd, wsd, wbx, true))
    return static_cast<int>(cudaErrorInvalidValue);
  // out [Tout, H, W, Cout] bf16: a box of one 8 x 8-pixel block by n_tile
  // channels, where the rows are 16-byte multiples (else plain stores)
  p.tma_store = n_tile == 96 && (Cout * 2) % 16 == 0 &&
                (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  to = tx;
  if (p.tma_store) {
    const cuuint64_t od[4] = {static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(Tout)};
    const cuuint64_t os[3] = {static_cast<cuuint64_t>(Cout) * 2,
                              static_cast<cuuint64_t>(W) * Cout * 2,
                              static_cast<cuuint64_t>(H) * W * Cout * 2};
    const cuuint32_t ob[4] = {static_cast<cuuint32_t>(n_tile), 8, 8, 1};
    if (!encode(&to, out, false, 4, od, os, ob, false))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(int8 ? launch_cfg<true>(tx, tw, to, p, n_tile, wgs, s)
                               : launch_cfg<false>(tx, tw, to, p, n_tile, wgs, s));
}

// x [n] bf16 (16-byte aligned, n a multiple of 8) -> q [n] s8 codes
// (16-byte aligned); scal [2] f32 scratch: scal[0] the absmax (zeroed here,
// then max-combined), scal[1] receives s_x.
extern "C" int inferix_conv_act_quant(const void* x, void* q, void* scal, long long n,
                                      void* stream) {
  if (n <= 0 || n % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(q) & 7) || scal == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* amax = static_cast<unsigned*>(scal);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long n8 = n / 8;
  const long long want = (n8 + kQThreads - 1) / kQThreads;
  const int grid = static_cast<int>(std::min(want, static_cast<long long>(sms) * 8));
  absmax_kernel<<<grid, kQThreads, 0, s>>>(static_cast<const uint4*>(x), n8, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  codes_kernel<<<grid, kQThreads, 0, s>>>(static_cast<const uint4*>(x), static_cast<uint2*>(q),
                                          n8, amax, static_cast<float*>(scal) + 1);
  return static_cast<int>(cudaGetLastError());
}
