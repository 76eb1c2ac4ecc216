// Stride-1 3x3(xkt) convolution for NVIDIA Hopper (sm_90a): the VAE decode's
// hot convs, in bf16 and in W8A8.
//
// Replaces two TPU kernels of inferix_tpu/ops/halo_conv.py:
//   `_halo_conv_kernel` (body :59, pallas_call :270, wrapper halo_conv3d
//   :225): bf16 operands, f32 accumulation, + bias in f32;
//   `_halo_conv_kernel_i8` (body :113, pallas_call :200, wrapper
//   halo_conv3d_w8a8 :161): int8 codes, exact int32 sums, then
//   f32(acc) * sv + b in f32 (sv = s_x * s_w per output channel).
//
// Contract (the JAX wrappers'; the quantization of x and w stays in the
// Python wrapper, as it stays in XLA there):
//   x [Tin, H, W, Cin] bf16 or s8, contiguous, Cin a multiple of 16 bytes;
//   w [Cout, kt, 9, Cin_pad] bf16 or s8 (Cin_pad = Cin rounded up to 32,
//   zero-filled): per output channel, its K = kt*9*Cin_pad values
//   contiguous, the tap (dh, dw) as dh*3 + dw;
//   bias [Cout] f32; sv [Cout] f32 (W8A8 only);
//   out [Tout, H, W, Cout] bf16, Tout = Tin - kt + 1.
// Temporal VALID (the causal caller prepends kt - 1 frames), spatial SAME
// (zeros at the border), stride 1.
//   bf16: out = bf16(sum_taps,c x*w (f32) + bias)
//   W8A8: out = bf16(__fadd_rn(__fmul_rn(__int2float_rn(acc), sv), bias)),
//         the JAX order `acc.astype(f32) * sv + b` with no FMA contraction.
//
// Bound on an H100 SXM: 2*Tout*H*W*Cout*kt*9*Cin operations at 989 TFLOP/s
// (bf16) or 1979 TOP/s (int8), against the input, weights and output read
// or written once at 3.35 TB/s. The decode's hottest class, [4+2, 480, 832,
// 96] 3x3x3 96 -> 96 in bf16, is 0.795 TFLOP -> 0.80 ms against 0.23 ms of
// bytes: the convs are bound by operations (the RGB head, 96 -> 3, by
// bytes).
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work). An implicit GEMM: M = output pixels, N = Cout, K = taps x
// Cin. A CTA of 4 warps owns an 8 x 16 tile of output pixels of one frame
// and a BN-wide slice of Cout (BN 64, 32 or 16, chosen by the wrapper to
// divide Cout where it can). K advances over (dt, 32-channel chunk) stages.
// Each stage stages, with cp.async through two buffers, the 10 x 18 halo of
// the tile at frame t + dt and those 32 channels (zero-filled at the SAME
// border and past Cin), and the 9 taps' BN x 32 weights; the 9 taps then
// read shifted windows of the one halo in shared memory: an ldmatrix row
// address is per lane, so the shift is in the address and no shifted copy
// exists anywhere (the TPU kernel builds an im2col panel in VMEM instead).
// Products are mma.sync m16n8k16 bf16 (f32 accumulate) or m16n8k32 s8
// (s32 accumulate), each warp 2 x 16 pixels by BN. Pixel rows of 64 (bf16)
// or 32 (int8) bytes are XOR-swizzled in 16-byte chunks so that 8
// consecutive pixels at one chunk hit 8 bank groups. Ragged edges (H and W
// not tile multiples, Cout 3, Cin 16) are zero-filled on load and masked on
// store.
//
// C interface: raw pointers, the stream; the launcher allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8, kTW = 16;                 // output tile: 8 rows x 16 cols
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;         // 180 halo pixels
constexpr int kBK = 32;                          // channels a stage
constexpr int kThreads = 128;                    // 4 warps x (2 rows of 16 pixels)

template <bool kInt8>
struct Cfg {
  static constexpr int kBPP = kInt8 ? 32 : 64;   // bytes of a pixel (or weight row) a stage
  static constexpr int kCPP = kBPP / 16;         // 16-byte chunks of it
  static constexpr int kElemsPerChunk = kInt8 ? 16 : 8;
  static constexpr int kKSteps = kInt8 ? 1 : 2;  // mma k-steps a tap a stage
  static constexpr int kSwzShift = kInt8 ? 2 : 1;
};

template <bool kInt8, int kBN>
__host__ __device__ constexpr int stage_bytes() {
  return (kHalo + 9 * kBN) * Cfg<kInt8>::kBPP;
}

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  const float* sv;
  __nv_bfloat16* out;
  int Tout, H, W, Cin, Cout, kt, cin_pad;
  int tiles_w;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of (row, 16-byte chunk) in a buffer of kBPP-byte rows, the
// chunk XOR-swizzled so 8 consecutive rows at one chunk hit 8 bank groups.
template <bool kInt8>
__device__ __forceinline__ int swz(int row, int chunk) {
  using C = Cfg<kInt8>;
  return row * C::kBPP + ((chunk ^ ((row >> C::kSwzShift) & (C::kCPP - 1))) << 4);
}

template <bool kInt8>
__device__ __forceinline__ float epilogue(float acc, float sv, float b) {
  return __fadd_rn(acc, b);
}

template <>
__device__ __forceinline__ float epilogue<true>(float acc, float sv, float b) {
  return __fadd_rn(__fmul_rn(acc, sv), b);
}

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(int a) { return __int2float_rn(a); }

template <bool kInt8, int kBN>
__global__ void __launch_bounds__(kThreads) halo_conv_kernel(const Params p) {
  using C = Cfg<kInt8>;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kNF = kBN / 8;                   // n8 fragments a warp
  constexpr int kStage = stage_bytes<kInt8, kBN>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = (blockIdx.x / p.tiles_w) * kTH;
  const int w0 = (blockIdx.x % p.tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int t = blockIdx.z;
  const int n_cc = p.cin_pad / kBK;
  const int n_stages = p.kt * n_cc;
  const uint8_t* x = static_cast<const uint8_t*>(p.x);
  const uint8_t* w = static_cast<const uint8_t*>(p.w);
  constexpr int kEsz = kInt8 ? 1 : 2;

  auto load_stage = [&](int s, int buf) {
    const int dt = s / n_cc, c0 = (s % n_cc) * kBK;
    unsigned char* sa = smem + buf * kStage;
    unsigned char* sb = sa + kHalo * C::kBPP;
    const long long frame = static_cast<long long>(t + dt) * p.H;
    for (int i = tid; i < kHalo * C::kCPP; i += kThreads) {
      const int px = i / C::kCPP, chunk = i % C::kCPP;
      const int gh = h0 + px / kHaloW - 1, gw = w0 + px % kHaloW - 1;
      const int ch = c0 + chunk * C::kElemsPerChunk;
      const bool ok = gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && ch < p.Cin;
      const long long off = ok ? ((frame + gh) * p.W + gw) * p.Cin + ch : 0;
      cp_async16(sa + swz<kInt8>(px, chunk), x + off * kEsz, ok);
    }
    for (int i = tid; i < 9 * kBN * C::kCPP; i += kThreads) {
      const int row = i / C::kCPP, chunk = i % C::kCPP;
      const int tap = row / kBN, n = n0 + row % kBN;
      const bool ok = n < p.Cout;
      const long long off =
          ok ? ((static_cast<long long>(n) * p.kt + dt) * 9 + tap) * p.cin_pad +
                   c0 + chunk * C::kElemsPerChunk
             : 0;
      cp_async16(sb + swz<kInt8>(row, chunk), w + off * kEsz, ok);
    }
  };

  Acc acc[2][kNF][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNF; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  load_stage(0, 0);
  cp_async_commit();

  // ldmatrix lanes: A x4 = 16 pixels (one tile row) at chunks (0, 1) of a
  // k-step; B x4 = two n8 fragments at chunks (0, 1)
  const int a_col = lane & 15, a_chunk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load_stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const unsigned char* sa = smem + (s & 1) * kStage;
    const unsigned char* sb = sa + kHalo * C::kBPP;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
#pragma unroll
      for (int ks = 0; ks < C::kKSteps; ++ks) {
        uint32_t af[2][4], bf[kNF / 2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int px = (2 * warp + mi + dh) * kHaloW + a_col + dw;
          ldsm_x4(af[mi], sa + swz<kInt8>(px, ks * 2 + a_chunk));
        }
#pragma unroll
        for (int nj = 0; nj < kNF / 2; ++nj)
          ldsm_x4(bf[nj], sb + swz<kInt8>(tap * kBN + nj * 16 + b_row, ks * 2 + b_chunk));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNF; ++ni)
            mma(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                bf[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    __syncthreads();  // this buffer is refilled two stages on
  }

  // Epilogue: rows g and g + 8 of each m16 fragment are output columns
  // w0 + g (+ 8) of tile row 2*warp + mi; columns 2*t4, 2*t4 + 1 of each n8.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int oh = h0 + 2 * warp + mi;
    if (oh >= p.H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + g + half * 8;
      if (ow >= p.W) continue;
      __nv_bfloat16* orow =
          p.out + ((static_cast<long long>(t) * p.H + oh) * p.W + ow) * p.Cout;
#pragma unroll
      for (int ni = 0; ni < kNF; ++ni) {
        const int n = n0 + ni * 8 + 2 * t4;
        if (n >= p.Cout) continue;
        const float sv0 = kInt8 ? p.sv[n] : 1.f;
        const float v0 = epilogue<kInt8>(to_float(acc[mi][ni][half * 2]), sv0, p.bias[n]);
        if (n + 1 < p.Cout) {
          const float sv1 = kInt8 ? p.sv[n + 1] : 1.f;
          const float v1 =
              epilogue<kInt8>(to_float(acc[mi][ni][half * 2 + 1]), sv1, p.bias[n + 1]);
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

template <bool kInt8, int kBN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = 2 * stage_bytes<kInt8, kBN>();
  cudaError_t err = cudaFuncSetAttribute(
      halo_conv_kernel<kInt8, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (p.H + kTH - 1) / kTH;
  const dim3 grid(tiles_h * p.tiles_w, (p.Cout + kBN - 1) / kBN, p.Tout);
  halo_conv_kernel<kInt8, kBN><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kInt8>
cudaError_t launch_bn(const Params& p, int bn, cudaStream_t stream) {
  if (bn == 64) return launch<kInt8, 64>(p, stream);
  if (bn == 32) return launch<kInt8, 32>(p, stream);
  if (bn == 16) return launch<kInt8, 16>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// int8 = 0: bf16 x and w, sv ignored; int8 = 1: s8 x and w, sv [Cout] f32.
extern "C" int inferix_halo_conv3d(const void* x, const void* w,
                                   const void* bias, const void* sv, void* out,
                                   int Tout, int H, int W, int Cin, int Cout,
                                   int kt, int cin_pad, int bn, int int8,
                                   void* stream) {
  const int align = int8 ? 16 : 8;  // Cin elements in a 16-byte chunk
  if (Cin % align != 0 || cin_pad % kBK != 0 || cin_pad < Cin || Tout <= 0 ||
      H <= 0 || W <= 0 || Cout <= 0 || kt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.sv = static_cast<const float*>(sv);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Tout = Tout; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.kt = kt; p.cin_pad = cin_pad;
  p.tiles_w = (W + kTW - 1) / kTW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(int8 ? launch_bn<true>(p, bn, s) : launch_bn<false>(p, bn, s));
}
