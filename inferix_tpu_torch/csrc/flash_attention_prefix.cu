// Prefix-span flash attention for NVIDIA Hopper (sm_90a): q attends over the
// live span [kv_start, kv_end) of a KV cache, per batch row.
//
// Replaces the TPU kernel `_flash_kernel` of
// inferix_tpu/ops/flash_attention.py (body :53, pallas_call :329, wrapper
// flash_attention_prefix :204) over a bf16 or a scale-free fp8 e4m3 K/V
// cache (the TPU kernel casts e4m3 to q's dtype, :126, :142). The int8-KV
// kernel (`_flash_kernel_quant`, :390) runs on csrc/flash_attention_sm90.cu.
//
// Contract (the same as the TPU kernel's):
//   q [B, Sq, H, 128] bf16, k/v [B, Skv, H, 128] bf16 or e4m3
//   (token-major cache layer slices, any row/batch/head strides; the head dim
//   is contiguous), bounds [B, 2] int32 on the device = (kv_start, kv_end)
//   per batch row, out [B, Sq, H, 128] bf16, optional lse [B, H, Sq] float32.
//
// The exp2 domain: q is pre-multiplied by scale*log2(e) and rounded back to
// bf16 (as the TPU wrapper does, flash_attention.py:270-271; here on the load
// into shared memory), so p = exp2(s). The denominator is max(l, 1e-30) and
// the LSE goes back to the natural log by dividing by log2(e) (:165-174).
// Softmax modes: `fixedm` (no running max; exact while |natural logit| <~ 60,
// which every normalised-QK attention satisfies, :79-86) and `runmax` (the
// classic running max, for unbounded logits).
// e4m3 values widen to bf16 exactly, so the products are those of a bf16
// cache holding the same values.
//
// Bound on an H100 SXM: 4*Sq*span*H*128 FLOP on the tensor cores against
// (Sq + 2*span)*H*128 bytes of q and K/V at their widths. At the main path's
// full cache (B=1, Sq=4680, H=12, span=32760) that is 0.94 TFLOP -> 0.95 ms
// at 989 TFLOP/s, against 201 MB of bf16 K/V (0.06 ms at 3.35 TB/s) or half
// that in e4m3: both variants are bound by operations, and the 1-byte
// cache buys capacity, not speed.
//
// Design (simple and right first; wgmma/TMA and warp specialisation are later
// work): one CTA of 4 warps per (64-row q tile, batch*head). Each warp owns
// 16 q rows and keeps its q fragments, its fp32 output accumulator and its
// softmax state in registers. The CTA walks the live span only, in 64-token
// K/V tiles that start at kv_start (so only the last tile is ragged), staged
// through shared memory by cp.async with two buffers, so the next tile loads
// while this one is multiplied. A bf16 tile lands directly in its swizzled
// bf16 buffer. An e4m3 tile (16 values per 16-byte copy) lands in a raw
// buffer, and one pass over shared memory widens it into the swizzled bf16 tile
// that the bf16 path's ldmatrix loads read unchanged. Products are bf16
// mma.sync m16n8k16 with fp32 accumulation; shared memory is XOR-swizzled
// in 16-byte chunks so ldmatrix reads are free of bank conflicts. Where the
// TPU grid padded Sq and Skv to its q/kv blocks, this kernel masks the
// ragged edges: q rows past Sq are neither loaded nor stored, and key
// columns past kv_end get a logit of -1e30 (p = 0) while their K/V rows
// are zero-filled. The span bounds are read from device memory,
// so a caller needs no host sync and no span buckets.
//
// C interface: raw pointers, element strides, the stream; the launchers
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 128;                       // 4 warps x 16 q rows
constexpr int kTileElems = 64 * kHeadDim;           // one 64 x 128 bf16 tile
constexpr int kChunksPerThread = kTileElems / 8 / kThreads;  // 16 B chunks
constexpr int kRawTile = 64 * kHeadDim;             // one 64 x 128 1-byte tile
constexpr int kRawChunksPerThread = kRawTile / 16 / kThreads;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// K/V storage kinds, the launcher's `kv_kind` codes (kind 2, int8, is
// csrc/flash_attention_sm90.cu's).
constexpr int kBF16 = 0, kE4M3 = 1;

// Shared memory: bf16 K/V: Q + 2 x (K, V) tiles = 80 KB. e4m3 K/V: Q + the
// widened K and V + 2 x (raw K, raw V) = 80 KB.
constexpr int smem_bytes(int kv) {
  return kv == kBF16 ? 5 * kTileElems * 2 : 3 * kTileElems * 2 + 4 * kRawTile;
}

struct Params {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  __nv_bfloat16* out;
  float* lse;
  const int* bounds;
  int B, H, Sq, Skv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float q_scale;  // scale * log2(e)
};

// Element offset of (row, col) in a 64 x 128 tile whose 16-byte chunks are
// XOR-swizzled by row: eight rows at one column land in eight bank groups.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kHeadDim + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
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

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One stored e4m3 byte as a float (exact in bf16).
template <int kKV>
__device__ __forceinline__ float byte_to_float(uint32_t byte) {
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(f);
}

// Four stored bytes (one 32-bit word) widened to four bf16 values.
template <int kKV>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  return make_uint2(pack_bf16(byte_to_float<kKV>(w & 0xffu),
                              byte_to_float<kKV>((w >> 8) & 0xffu)),
                    pack_bf16(byte_to_float<kKV>((w >> 16) & 0xffu),
                              byte_to_float<kKV>(w >> 24)));
}

template <int kKV, bool kRunMax>
__global__ void __launch_bounds__(kThreads, 2)
    flash_prefix_kernel(const Params p) {
  constexpr bool kByte = kKV != kBF16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileElems;                // 2 buffers for bf16
  __nv_bfloat16* sV = sK + (kByte ? 1 : 2) * kTileElems;
  uint8_t* sRaw = reinterpret_cast<uint8_t*>(sV + kTileElems);  // e4m3 K/V

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;    // mma fragment row / column pair
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;

  const int kv_start = max(p.bounds[2 * b], 0);
  const int kv_end = min(p.bounds[2 * b + 1], p.Skv);
  const int n_tiles = max(kv_end - kv_start, 0) / kBlockKV +
                      ((max(kv_end - kv_start, 0) % kBlockKV) != 0);

  // element (= byte for 1-byte K/V) offsets of this (batch, head)
  const long long k_off = b * p.k_sb + h * p.k_sh;
  const long long v_off = b * p.v_sb + h * p.v_sh;

  auto load_kv = [&](int tile, int buf) {
    const int base = kv_start + tile * kBlockKV;
    if constexpr (!kByte) {
      const __nv_bfloat16* kbase = static_cast<const __nv_bfloat16*>(p.k) + k_off;
      const __nv_bfloat16* vbase = static_cast<const __nv_bfloat16*>(p.v) + v_off;
      __nv_bfloat16* dk = sK + buf * kTileElems;
      __nv_bfloat16* dv = sV + buf * kTileElems;
#pragma unroll
      for (int i = 0; i < kChunksPerThread; ++i) {
        const int c = tid + i * kThreads;
        const int row = c >> 4, col = (c & 15) << 3;
        const bool ok = base + row < kv_end;
        const long long tok = ok ? base + row : kv_start;
        cp_async16(dk + swz(row, col), kbase + tok * p.k_ss + col, ok);
        cp_async16(dv + swz(row, col), vbase + tok * p.v_ss + col, ok);
      }
    } else {
      const uint8_t* kbase = static_cast<const uint8_t*>(p.k) + k_off;
      const uint8_t* vbase = static_cast<const uint8_t*>(p.v) + v_off;
      uint8_t* dk = sRaw + buf * 2 * kRawTile;
      uint8_t* dv = dk + kRawTile;
#pragma unroll
      for (int i = 0; i < kRawChunksPerThread; ++i) {
        const int c = tid + i * kThreads;
        const int row = c >> 3, col = (c & 7) << 4;
        const bool ok = base + row < kv_end;
        const long long tok = ok ? base + row : kv_start;
        cp_async16(dk + row * kHeadDim + col, kbase + tok * p.k_ss + col, ok);
        cp_async16(dv + row * kHeadDim + col, vbase + tok * p.v_ss + col, ok);
      }
    }
  };

  // 1-byte K/V: widen raw buffer `buf` into the swizzled bf16 tiles sK, sV.
  auto widen_kv = [&](int buf) {
    const uint8_t* rk = sRaw + buf * 2 * kRawTile;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint8_t* src = rk + t * kRawTile;
      __nv_bfloat16* dst = t == 0 ? sK : sV;
#pragma unroll
      for (int i = 0; i < kRawChunksPerThread; ++i) {
        const int c = tid + i * kThreads;
        const int row = c >> 3, col = (c & 7) << 4;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + row * kHeadDim + col);
        const uint2 a = widen4<kKV>(raw.x), bb = widen4<kKV>(raw.y);
        const uint2 cc = widen4<kKV>(raw.z), d = widen4<kKV>(raw.w);
        *reinterpret_cast<uint4*>(dst + swz(row, col)) = make_uint4(a.x, a.y, bb.x, bb.y);
        *reinterpret_cast<uint4*>(dst + swz(row, col + 8)) = make_uint4(cc.x, cc.y, d.x, d.y);
      }
    }
  };

  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // q tile -> shared memory, pre-scaled into the exp2 domain and rounded
  // back to bf16 on the way (the TPU wrapper's rounding point).
  const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 4, col = (c & 15) << 3;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + row < p.Sq) {
      val = *reinterpret_cast<const uint4*>(
          qbase + (long long)(q0 + row) * p.q_ss + col);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        h2[j] = __floats2bfloat162_rn(f.x * p.q_scale, f.y * p.q_scale);
      }
    }
    *reinterpret_cast<uint4*>(sQ + swz(row, col)) = val;
  }
  __syncthreads();

  uint32_t qf[8][4];
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
    ldsm_x4(qf[kc], sQ + swz(warp * 16 + (lane & 15), kc * 16 + (lane >> 4) * 8));

  float o[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8 (runmax only)
  float l_r[2] = {0.f, 0.f};          // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if constexpr (kByte) {
      widen_kv(it & 1);
      __syncthreads();
    }
    const __nv_bfloat16* cK = sK + (kByte ? 0 : (it & 1) * kTileElems);
    const __nv_bfloat16* cV = sV + (kByte ? 0 : (it & 1) * kTileElems);

    // s = q k^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kc * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kc], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kb[2], kb[3]);
      }
    }
    const int tile_base = kv_start + it * kBlockKV;
    if (tile_base + kBlockKV > kv_end) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile_base + nt * 8 + 2 * t4 + (e & 1) >= kv_end) s[nt][e] = kNegInf;
    }

    if (kRunMax) {
      float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = exp2f(m_r[0] - mx0), c1 = exp2f(m_r[1] - mx1);
      m_r[0] = mx0;
      m_r[1] = mx1;
      l_r[0] *= c0;
      l_r[1] *= c1;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        o[dt][0] *= c0; o[dt][1] *= c0;
        o[dt][2] *= c1; o[dt][3] *= c1;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mx0); s[nt][1] = exp2f(s[nt][1] - mx0);
        s[nt][2] = exp2f(s[nt][2] - mx1); s[nt][3] = exp2f(s[nt][3] - mx1);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = exp2f(s[nt][e]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l_r[0] += s[nt][0] + s[nt][1];
      l_r[1] += s[nt][2] + s[nt][3];
    }
    // o += p v, p rounded to bf16 (the TPU kernel's p.astype(v.dtype))
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, cV + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // these buffers are refilled by the next iteration
  }

  float l0 = l_r[0], l1 = l_r[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* obase = p.out + b * p.o_sb + h * p.o_sh;
  if (r0 < p.Sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(obase + (long long)r0 * p.o_ss);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      dst[dt * 4 + t4] = pack_bf16(o[dt][0] / d0, o[dt][1] / d0);
  }
  if (r1 < p.Sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(obase + (long long)r1 * p.o_ss);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      dst[dt * 4 + t4] = pack_bf16(o[dt][2] / d1, o[dt][3] / d1);
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + (long long)bh * p.Sq;
    const float e0 = kRunMax ? m_r[0] + log2f(d0) : log2f(d0);
    const float e1 = kRunMax ? m_r[1] + log2f(d1) : log2f(d1);
    if (r0 < p.Sq) lse[r0] = e0 / kLog2e;
    if (r1 < p.Sq) lse[r1] = e1 / kLog2e;
  }
}

template <int kKV, bool kRunMax>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(kKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefix_kernel<kKV, kRunMax>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_prefix_kernel<kKV, kRunMax><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int kKV>
cudaError_t launch(const Params& p, int runmax, cudaStream_t stream) {
  return runmax ? launch_one<kKV, true>(p, stream)
                : launch_one<kKV, false>(p, stream);
}

void set_common(Params& p, const void* q, const void* k, const void* v,
                void* out, void* lse, const void* bounds, int B, int H,
                int Sq, int Skv, float q_scale) {
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.bounds = static_cast<const int*>(bounds);
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv;
  p.q_scale = q_scale;
}

}  // namespace

// bf16 (kv_kind 0) or e4m3 (kv_kind 1) K/V.
extern "C" int inferix_flash_attention_prefix(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* bounds, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float q_scale, int runmax, int kv_kind, void* stream) {
  Params p;
  set_common(p, q, k, v, out, lse, bounds, B, H, Sq, Skv, q_scale);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_kind == kBF16) return static_cast<int>(launch<kBF16>(p, runmax, s));
  if (kv_kind == kE4M3) return static_cast<int>(launch<kE4M3>(p, runmax, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
