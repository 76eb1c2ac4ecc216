// The norm chains of the bf16 Wan layer as row kernels for NVIDIA Hopper
// (sm_90a): each reads a token's bf16 row once, holds it in registers, takes
// its f32 statistics, applies the rest of the chain and writes the bf16
// result once.
//
//   row_ln_kernel        LayerNorm, cast to bf16, then the per-frame AdaLN
//                        modulate (the qkv, fc1 and head prologues), or the
//                        f32 affine weight and bias cast once (norm3), or
//                        the cast alone
//   row_rms_rope_kernel  RMS norm over the row, cast to bf16, times the bf16
//                        weight, then the 3-D rope from an f32 cos / sin
//                        table [S, head_dim / 2] (or one a batch row): the
//                        self-attention's q and k in one launch (gridDim.y
//                        2, each read through its row stride, e.g. straight
//                        from the fused qkv output), or one input without
//                        rope (the cross-attention's q)
//
// They replace chains of PyTorch operations, not a TPU kernel: the LayerNorm
// of ops/norms.py:layer_norm with models/wan/causal_dit.py:_modulate, the
// qk-norm of parallel/tensor_parallel.py:rms_norms_tp at tp 1, and
// ops/rope.py:apply_rope (wrappers ops/row_norm.py: ln_rows, rms_rows).
//
// Numerics are the chain's as PyTorch runs it on the card, rounding point for
// rounding point: f32 statistics, `mean` as the row's sum times RN(1 / C)
// (PyTorch's CUDA mean), (x - mean)^2 for the variance, rsqrtf as
// torch.rsqrt, each product and sum an explicit _rn intrinsic (no FMA
// contraction: the chain runs each operation as its own kernel), and a value
// rounded to bf16 where the chain casts it or computes in bf16:
//   LN        bf16((x - mean) * r);
//   modulate  bf16(bf16(h * bf16(1 + scale)) + bf16(shift)), the bf16 product
//             and sum each taken in f32 and rounded;
//   affine    bf16((x - mean) * r * w + b) in f32, w and b the bf16 weights;
//   RMS       bf16(bf16(x * r) * w);
//   rope      bf16(y0 c - y1 s), bf16(y1 c + y0 s) for each pair (y0, y1),
//             each product and the sum rounded to f32.
// The results differ from the chain only where the row's sums, added in
// another order, round to another f32 statistic.
//
// Bound on an H100 SXM: bytes. Each row is read once and written once (2C +
// 2C bytes; q and k twice that), the operands come from L2: 0.0086 ms for a
// 4680 x 1536 LayerNorm, 0.0172 ms for q and k.
//
// Design: the register-resident row frame of csrc/act_quant.cu. A group of G
// threads owns a row, lane l holding its 16-byte chunks l, l + G, ... as
// packed bf16; the class (G, chunks a thread) comes from the width
// (ops/act_quant.py:row_plan) and the launcher refuses a class it was not
// built for: G 16 with 1 chunk (widths <= 128), G 32 with up to 6 (<= 1536),
// G 128 with up to 9 or 12 (<= 12288). Reductions are warp shuffles within
// the group, and across the 4 warps of a G 128 row through 8 floats of
// shared memory used in turns. Each group takes kRowsPerGroup consecutive
// rows. A CTA stages its operands in shared memory once for all its groups:
// bf16(1 + scale) and bf16(shift) of each frame its rows touch, the affine
// weight and bias, or the RMS weight. The rope reads its 4 cos and 4 sin of
// a chunk from the table (L1 / L2: the table is shared by the row's heads).
//
// C interface: raw pointers, the class, the stream; the launchers allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum LnMode { kPlain = 0, kAffine = 1, kModulate = 2 };

// The row classes (ops/act_quant.py:ROW_CLASSES): G threads a row, each
// holding at most kChunks 16-byte chunks of it; kThreads threads a CTA.
template <int G, int kChunks_>
struct RowClass {
  static constexpr int kChunks = kChunks_;
  static constexpr int kThreads = G == 16 ? 256 : 128;
  static constexpr int kGroups = kThreads / G;
};
// Rows a group takes in turn.
constexpr int kRowsPerGroup = 2;

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

// The f32 sum of 8 values as a tree.
__device__ __forceinline__ float sum8(const float (&v)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// The sum over the G threads of a row; every thread of the group gets the
// same value. G 128, a whole CTA, goes on through `red`: 2 x 4 floats used in
// turns, so one barrier a call suffices (a warp writes a slot again only
// after the next call's barrier, which every reader of the slot has passed).
template <int G>
__device__ __forceinline__ float group_sum(float v, float (*red)[4], int& turn) {
  constexpr int kWidth = G < 32 ? G : 32;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (G > 32) {
    float* r = red[turn];
    turn ^= 1;
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    v = r[0];
#pragma unroll
    for (int i = 1; i < G / 32; ++i) v = __fadd_rn(v, r[i]);
  }
  return v;
}

// A row's chunks into registers (zeros for a dead row).
template <int G, int kChunks>
__device__ __forceinline__ void load_row(uint4 (&xv)[kChunks], const __nv_bfloat16* xr,
                                         bool live, int lane, int n) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = j * G + lane;
    xv[j] = live && c < n ? load16(xr + c * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// bf16(one + p[i]) for 8 consecutive f32 of a modulation row (a strided
// view): two 16-byte loads when aligned, else 8 4-byte loads. one = -0 gives
// bf16(p[i]) (-0 + v is v, +0 and -0 kept).
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

// Each group takes `per` rows in turn; the grid covers the rows once.
template <int kGroups>
int ctas_for(int m, int per) {
  return static_cast<int>((m + static_cast<long long>(per) * kGroups - 1) /
                          (static_cast<long long>(per) * kGroups));
}

// The frames a run of `rows` consecutive rows can touch (frames of frame_seq
// rows): the modulation slots a CTA stages.
__host__ __device__ inline int frame_slots(int rows, int frame_seq) {
  return (rows - 1 + frame_seq - 1) / frame_seq + 1;
}

struct LnArgs {
  const __nv_bfloat16* x;    // [m, C] rows, contiguous
  __nv_bfloat16* out;        // [m, C]
  const void* p0;            // modulate: shift f32; affine: weight bf16 [C]
  const void* p1;            // modulate: scale f32; affine: bias bf16 [C]
  long long mod_sb, mod_sf;  // modulation strides (batch, frame), elements
  int m, C, rows_per_batch, frame_seq, per;
  float eps;
};

// Shared memory of the LayerNorm kernel, bytes, for rows of n chunks.
template <int kMode>
int ln_smem_bytes(int rows_per_cta, int frame_seq, int n) {
  return kMode == kModulate ? frame_slots(rows_per_cta, frame_seq) * 2 * n * 16
                            : kMode == kAffine ? 2 * n * 16 : 0;
}

template <int kMode, int G, int kChunks>
__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads) row_ln_kernel(LnArgs p) {
  using RC = RowClass<G, kChunks>;
  constexpr int kGroups = RC::kGroups;
  extern __shared__ uint4 operands[];
  __shared__ float red[2][4];
  int turn = 0;
  const int lane = threadIdx.x % G;
  const int C = p.C, n = C >> 3;
  const float inv_c = __frcp_rn(static_cast<float>(C));
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
      operands[c] = load16(static_cast<const __nv_bfloat16*>(p.p0) + c * 8);
      operands[n + c] = load16(static_cast<const __nv_bfloat16*>(p.p1) + c * 8);
    }
    __syncthreads();
  }
  for (int i = 0; i < p.per; ++i) {
    const long long row = begin + i;
    const bool live = row < end;
    if (i > 0) load_row<G>(xv, p.x + row * C, live, lane, n);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * G + lane < n) {
        float v[8];
        unpack8(xv[j], v);
        sum = __fadd_rn(sum, sum8(v));
      }
    }
    const float mean = __fmul_rn(group_sum<G>(sum, red, turn), inv_c);
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
    const float var = __fmul_rn(group_sum<G>(sq, red, turn), inv_c);
    const float r = rsqrtf(__fadd_rn(var, p.eps));
    if (!live) continue;
    const uint4* pair =
        kMode == kModulate ? operands + 2 * n * (row / p.frame_seq - key0) : operands;
    __nv_bfloat16* out = p.out + row * C;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = j * G + lane;
      if (c < n) {
        float v[8], h[8];
        unpack8(xv[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = __fmul_rn(__fsub_rn(v[e], mean), r);
        if (kMode == kModulate) {
          float sc[8], sh[8];
          unpack8(pair[c], sc);
          unpack8(pair[n + c], sh);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            h[e] = __fadd_rn(bf16_round(__fmul_rn(bf16_round(h[e]), sc[e])), sh[e]);
        } else if (kMode == kAffine) {
          float w[8], b[8];
          unpack8(pair[c], w);
          unpack8(pair[n + c], b);
#pragma unroll
          for (int e = 0; e < 8; ++e) h[e] = __fadd_rn(__fmul_rn(h[e], w[e]), b[e]);
        }
        *reinterpret_cast<uint4*>(out + c * 8) = pack8_rn(h);  // the last rounding to bf16
      }
    }
  }
}

struct RmsArgs {
  const __nv_bfloat16* x0;   // input 0 (q): rows x_stride elements apart
  const __nv_bfloat16* x1;   // input 1 (k), or null
  __nv_bfloat16* out0;       // [m, C], contiguous
  __nv_bfloat16* out1;
  const __nv_bfloat16* w0;   // the norms' weights [C]
  const __nv_bfloat16* w1;
  const float* cos;          // rope table [.., S, half] f32, or null: no rope
  const float* sin;
  long long x_stride;        // elements between rows of an input
  long long tab_sb;          // elements between batch rows of the tables (0: one table)
  int m, C, rows_per_batch, half, per;
  float eps;
};

template <bool kRope, int G, int kChunks>
__global__ void __launch_bounds__(RowClass<G, kChunks>::kThreads)
row_rms_rope_kernel(RmsArgs p) {
  using RC = RowClass<G, kChunks>;
  constexpr int kGroups = RC::kGroups;
  extern __shared__ uint4 weight[];
  __shared__ float red[2][4];
  int turn = 0;
  const bool second = blockIdx.y != 0;
  const __nv_bfloat16* x = second ? p.x1 : p.x0;
  const __nv_bfloat16* w = second ? p.w1 : p.w0;
  __nv_bfloat16* out_base = second ? p.out1 : p.out0;
  const int lane = threadIdx.x % G;
  const int C = p.C, n = C >> 3;
  const float inv_c = __frcp_rn(static_cast<float>(C));
  const long long begin =
      (static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / G) * p.per;
  const long long end = min(static_cast<long long>(p.m), begin + p.per);
  uint4 xv[kChunks];
  load_row<G>(xv, x + begin * p.x_stride, begin < end, lane, n);
  for (int c = threadIdx.x; c < n; c += RC::kThreads) weight[c] = load16(w + c * 8);
  __syncthreads();
  for (int i = 0; i < p.per; ++i) {
    const long long row = begin + i;
    const bool live = row < end;
    if (i > 0) load_row<G>(xv, x + row * p.x_stride, live, lane, n);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * G + lane < n) {
        float v[8];
        unpack8(xv[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], v[e]);
        sq = __fadd_rn(sq, sum8(v));
      }
    }
    const float ms = __fmul_rn(group_sum<G>(sq, red, turn), inv_c);
    const float r = rsqrtf(__fadd_rn(ms, p.eps));
    if (!live) continue;
    // the row's token and batch row give its line of the rope table
    const long long tab = kRope ? row / p.rows_per_batch * p.tab_sb
                                      + row % p.rows_per_batch * p.half
                                : 0;
    __nv_bfloat16* out = out_base + row * C;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = j * G + lane;
      if (c < n) {
        float v[8], wv[8];
        unpack8(xv[j], v);
        unpack8(weight[c], wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(v[e], r)), wv[e]));
        if (kRope) {
          // the chunk's 4 pairs lie in one head (head_dim % 8 == 0): pair
          // j0 + k of the head at column 8c + 2k
          const int j0 = (c * 4) % p.half;
          const float4 cs = __ldg(reinterpret_cast<const float4*>(p.cos + tab + j0));
          const float4 sn = __ldg(reinterpret_cast<const float4*>(p.sin + tab + j0));
          const float cv[4] = {cs.x, cs.y, cs.z, cs.w}, sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float y0 = v[2 * k], y1 = v[2 * k + 1];
            v[2 * k] = __fadd_rn(__fmul_rn(y0, cv[k]), __fmul_rn(-y1, sv[k]));
            v[2 * k + 1] = __fadd_rn(__fmul_rn(y1, cv[k]), __fmul_rn(y0, sv[k]));
          }
        }
        *reinterpret_cast<uint4*>(out + c * 8) = pack8_rn(v);
      }
    }
  }
}

// The dynamic shared memory opt-in, per device (cudaFuncSetAttribute sets a
// kernel's attribute for the device current at the call).
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
cudaError_t launch_ln(LnArgs p, cudaStream_t stream) {
  using RC = RowClass<G, kChunks>;
  constexpr int kRowsPerCta = RC::kGroups * kRowsPerGroup;
  // the most the class can stage (one frame a row, the widest row): past the
  // default 48 KB for the wide rows
  static bool opted[kMaxDevices] = {};
  const cudaError_t opt_in = smem_opt_in(row_ln_kernel<kMode, G, kChunks>,
                                         ln_smem_bytes<kMode>(kRowsPerCta, 1, kChunks * G),
                                         opted);
  if (opt_in != cudaSuccess) return opt_in;
  p.per = kRowsPerGroup;
  row_ln_kernel<kMode, G, kChunks>
      <<<ctas_for<RC::kGroups>(p.m, p.per), RC::kThreads,
         ln_smem_bytes<kMode>(kRowsPerCta, p.frame_seq, p.C >> 3), stream>>>(p);
  return cudaGetLastError();
}

template <bool kRope, int G, int kChunks>
cudaError_t launch_rms(RmsArgs p, int inputs, cudaStream_t stream) {
  using RC = RowClass<G, kChunks>;
  p.per = kRowsPerGroup;
  const dim3 grid(ctas_for<RC::kGroups>(p.m, p.per), inputs);
  row_rms_rope_kernel<kRope, G, kChunks>
      <<<grid, RC::kThreads, (p.C >> 3) * 16, stream>>>(p);
  return cudaGetLastError();
}

// The plan covers a row of n chunks exactly as ops/act_quant.py:row_plan
// does: nc = ceil(n / g).
bool covers(int n, int g, int nc) {
  return nc >= 1 && static_cast<long long>(nc - 1) * g < n &&
         static_cast<long long>(nc) * g >= n;
}

template <int kMode>
cudaError_t ln_class(const LnArgs& p, int g, int nc, cudaStream_t st) {
  if (g == 16 && nc <= 1) return launch_ln<kMode, 16, 1>(p, st);
  if (g == 32 && nc <= 6) return launch_ln<kMode, 32, 6>(p, st);
  if (g == 128 && nc <= 9) return launch_ln<kMode, 128, 9>(p, st);
  if (g == 128 && nc <= 12) return launch_ln<kMode, 128, 12>(p, st);
  return cudaErrorInvalidValue;
}

template <bool kRope>
cudaError_t rms_class(const RmsArgs& p, int inputs, int g, int nc, cudaStream_t st) {
  if (g == 16 && nc <= 1) return launch_rms<kRope, 16, 1>(p, inputs, st);
  if (g == 32 && nc <= 6) return launch_rms<kRope, 32, 6>(p, inputs, st);
  if (g == 128 && nc <= 9) return launch_rms<kRope, 128, 9>(p, inputs, st);
  if (g == 128 && nc <= 12) return launch_rms<kRope, 128, 12>(p, inputs, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// LayerNorm rows -> bf16. mode 0: the cast alone; 1: affine (p0 weight, p1
// bias, bf16 [c]); 2: modulate (p0 shift, p1 scale: f32 rows of c at
// b * mod_sb + f * mod_sf for frame f of batch row b, the token's frame its
// row within the batch row / frame_seq).
extern "C" int inferix_row_ln(const void* x, void* out, const void* p0, const void* p1,
                              long long mod_sb, long long mod_sf, int m, int c,
                              int rows_per_batch, int frame_seq, float eps, int mode, int g,
                              int nc, void* stream) {
  if (m <= 0 || c <= 0 || c % 8 != 0 || !covers(c / 8, g, nc) ||
      (mode != kPlain && (p0 == nullptr || p1 == nullptr)) ||
      (mode == kModulate && (rows_per_batch <= 0 || frame_seq <= 0 ||
                             rows_per_batch % frame_seq != 0 || m % rows_per_batch != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  LnArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.p0 = p0;
  p.p1 = p1;
  p.mod_sb = mod_sb;
  p.mod_sf = mod_sf;
  p.m = m;
  p.C = c;
  p.rows_per_batch = mode == kModulate ? rows_per_batch : m;
  p.frame_seq = mode == kModulate ? frame_seq : m;
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

// RMS rows -> bf16 times the weight (+ rope): `inputs` (1 or 2) inputs of m
// rows of c, x_stride elements apart, each with its weight, into contiguous
// outputs. cos / sin null: no rope; else [.., rows_per_batch, head_dim / 2]
// f32 tables, tab_sb elements apart a batch row (0: one table for all).
extern "C" int inferix_row_rms_rope(const void* x0, const void* x1, void* out0, void* out1,
                                    const void* w0, const void* w1, long long x_stride,
                                    const void* cos, const void* sin, long long tab_sb, int m,
                                    int c, int rows_per_batch, int head_dim, int inputs,
                                    float eps, int g, int nc, void* stream) {
  const bool rope = cos != nullptr;
  if (m <= 0 || c <= 0 || c % 8 != 0 || !covers(c / 8, g, nc) || x_stride < c ||
      x_stride % 8 != 0 || inputs < 1 || inputs > 2 ||
      (inputs == 2 && (x1 == nullptr || out1 == nullptr || w1 == nullptr)) ||
      (rope && (sin == nullptr || head_dim <= 0 || head_dim % 8 != 0 || c % head_dim != 0 ||
                rows_per_batch <= 0 || m % rows_per_batch != 0 || tab_sb % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  RmsArgs p;
  p.x0 = static_cast<const __nv_bfloat16*>(x0);
  p.x1 = static_cast<const __nv_bfloat16*>(x1);
  p.out0 = static_cast<__nv_bfloat16*>(out0);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.w0 = static_cast<const __nv_bfloat16*>(w0);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.x_stride = x_stride;
  p.tab_sb = tab_sb;
  p.m = m;
  p.C = c;
  p.rows_per_batch = rope ? rows_per_batch : m;
  p.half = rope ? head_dim / 2 : 0;
  p.per = 0;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rope ? rms_class<true>(p, inputs, g, nc, st)
                               : rms_class<false>(p, inputs, g, nc, st));
}
