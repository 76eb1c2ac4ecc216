// Int8-PV flash attention over an int8 K/V cache for NVIDIA Hopper (sm_90a):
// q attends over the prefix [0, kv_len) of an int8 cache with one f32 scale
// per (token, head), and the PV product runs on int8 codes of p.
//
// Replaces two TPU kernels of inferix_tpu/ops/flash_attention.py:
//   mode 0, `_flash_kernel_quant_i8` (body :660, pallas_call :841, wrapper
//   flash_attention_prefix_quant_i8 :740): int8 QK on q quantized per
//   (token, head) by the wrapper, int8 PV on p * v_scale requantized per row;
//   mode 1, `_flash_kernel_quant_v2` (body :962, pallas_call :1122, wrapper
//   flash_attention_prefix_quant_v2 :1039): bf16 QK (int8 k widened), int8
//   PV on p quantized with the fixed 127 against the group's max V scale.
//
// Contract (the TPU kernels'): q [B, Sq, H, 128] (mode 0: int8 codes with
// q_scale [B, Sq, H] f32 contiguous, the scale that folds dequantization,
// softmax scale and log2(e); mode 1: bf16, pre-scaled here by
// q_scale = scale * log2(e) and rounded back to bf16 on the load), k/v
// [B, Skv, H, 128] int8 and k_scale/v_scale [B, Skv, H] f32 (any strides;
// the head dim contiguous), kv_len [B] int32 on the device, out
// [B, Sq, H, 128] bf16 contiguous, optional lse [B, H, Sq] f32.
//
// The numerics hang on the kv group of G keys (the TPU kernel's kv_block, a
// runtime argument here, a multiple of the 64-key tile). Per group, with s
// the exp2-domain logits and keys past kv_len masked to -1e30:
//   m_new = max(m, max_j s_j)   (the whole group, before any p is formed)
//   corr = exp2(m - m_new), p_j = exp2(s_j - m_new), l = l * corr + sum p
//   mode 0: s = f32(q_i8 . k_i8) * q_scale * k_scale;
//           u_j = (p_j * vs_j) * (127 / rmax), rmax = max(max_j p_j vs_j, 1e-20)
//           deq = rmax / 127
//   mode 1: s = f32(q_bf16 . bf16(k_i8)) * k_scale;
//           vsb = max(max of the group's v scales in the cache, 1e-20)
//           u_j = p_j * (vs_j * (127 / vsb)), deq = vsb / 127
//   codes c_j = rint(u_j) (half to even, 0..127);
//   acc = acc * corr + f32(sum_j c_j v_j) * deq   (the sum exact in int32)
// and at the end out = acc / max(l, 1e-30), lse = (m + log2(max(l, 1e-30)))
// / log2(e). Every product, quotient and sum above is a separate _rn
// operation in the TPU kernel's order (nvcc may not contract them), and
// exp2f / log2f are those of the plain version on the card, so a code
// differs from the plain version's only where the logits differ (mode 1's
// f32 sums in another order) and u sits at a rounding tie.
//
// Bound on an H100 SXM: operations. At the full cache (B=1, Sq=4680, H=12,
// 32760 keys) each product is 4.71e11 operations: mode 0 both in int8
// (9.42e11 at 1979 TOP/s = 0.476 ms), mode 1 QK in bf16 at 989 TFLOP/s and
// PV in int8 (0.714 ms); K/V bytes (~100 MB) take 0.03 ms.
//
// Design (simple and right first): the first B1 kernel's frame (mma.sync,
// since replaced by csrc/flash_attention_sm90.cu), one CTA of 4 warps per
// (64-row q tile, batch*head), each warp 16 q rows with its fragments,
// accumulators and softmax state in registers, K/V tiles of 64 keys through a two-buffer cp.async ring. The group rule needs the
// whole group's row max before the first code (and mode 0 also the whole
// group's max of p * vs), so each group is walked in passes over the same
// tiles, the logits recomputed in each: pass 1 the max; (mode 0) pass 2 l
// and the p * vs max; last pass the codes and the int8 PV product. The ring
// runs across passes and groups, so the next tile always loads during this
// one. Products: mode 0 QK mma.sync m16n8k32 s8 (k tiles staged swizzled,
// read by ldmatrix as the int8 GEMM reads its weight); mode 1 QK m16n8k16
// bf16 on k widened into a bf16 tile (B2's pass); PV m16n8k32 s8. The B
// operand of PV needs each output column's keys contiguous, and ldmatrix
// transposes 16-bit elements only, so the V tile is transposed bytewise
// (__byte_perm, 4 x 4 blocks) into shared memory; its keys are permuted
// within each 32-key chunk into the order in which a thread's logits sit in
// the QK accumulator fragment, so the codes go from the QK fragment
// straight into the PV A fragment without a shuffle. mode 1's vsb is a
// block reduction over the group's v scales at the group's first tile.
// An optional `codes` output [B, H, Sq, Skv] u8 receives every code formed
// (for the rounding-event check on the card; the path passes null).
//
// C interface: raw pointers, element strides, the stream; the launcher
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kTile = 64;                      // keys a tile
constexpr int kThreads = 128;                  // 4 warps x 16 q rows
constexpr int kRaw = kTile * kHeadDim;         // one 64 x 128 int8 tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, by mode: q tile (int8 8 KB | bf16 16 KB), 2 x (k raw,
// v raw) 32 KB, 2 x (64 k, 64 v scales) 1 KB, the widened bf16 k tile
// (mode 1, 16 KB), the transposed v tile 8 KB, 128 floats of reduction.
__host__ __device__ constexpr int q_bytes(int mode) { return mode == 0 ? kRaw : 2 * kRaw; }
__host__ __device__ constexpr int smem_bytes(int mode) {
  return q_bytes(mode) + 4 * kRaw + 4 * kTile * 4 + (mode == 1 ? 2 * kRaw : 0) +
         kRaw + kThreads * 4;
}

struct Params {
  const void* q;
  const float* qs;      // mode 0
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  __nv_bfloat16* out;
  float* lse;
  const int* kv_len;
  uint8_t* codes;       // optional
  int B, H, Sq, Skv, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long ks_sb, ks_ss, ks_sh;
  long long vs_sb, vs_ss, vs_sh;
  float q_scale;        // mode 1: scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, 16-byte chunk) in a tile of 128-byte rows, chunks
// XOR-swizzled by row (int8 q and k tiles; bf16 tiles use swz_bf16).
__device__ __forceinline__ int swz8(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Element offset of (row, col) in a 64 x 128 bf16 tile, its 16-byte chunks
// XOR-swizzled by row.
__device__ __forceinline__ int swz_bf16(int row, int col) {
  return row * kHeadDim + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// Byte offset of (d, key') in the transposed v tile: 128 rows of 64 bytes,
// 16-byte chunks XOR-swizzled by (d >> 1) & 3 (8 rows at one chunk hit 8
// distinct 16-byte bank groups).
__device__ __forceinline__ int swz_vt(int d, int byte) {
  return d * 64 + ((((byte >> 4) ^ ((d >> 1) & 3))) << 4) + (byte & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float s8_to_float(uint32_t byte) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
}

// Four int8 bytes (one word) widened to four bf16 values (exact).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  return make_uint2(pack_bf16(s8_to_float(w & 0xffu), s8_to_float((w >> 8) & 0xffu)),
                    pack_bf16(s8_to_float((w >> 16) & 0xffu), s8_to_float(w >> 24)));
}

// Four codes 0..127 packed into one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Position of the walk: group g, pass, tile t of the group.
struct Cursor {
  int g, pass, t;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) flash_quant_ext_kernel(const Params p) {
  constexpr int kPasses = kMode == 0 ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sQ = smem;
  int8_t* sKraw = reinterpret_cast<int8_t*>(smem + q_bytes(kMode));  // [2][kRaw]
  int8_t* sVraw = sKraw + 2 * kRaw;                                    // [2][kRaw]
  float* sScale = reinterpret_cast<float*>(sVraw + 2 * kRaw);          // [2][k|v][64]
  __nv_bfloat16* sKw = reinterpret_cast<__nv_bfloat16*>(sScale + 4 * kTile);  // mode 1
  uint8_t* sVt = reinterpret_cast<uint8_t*>(sKw) + (kMode == 1 ? 2 * kRaw : 0);
  float* sRed = reinterpret_cast<float*>(sVt + kRaw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two q rows

  const int kv_end = min(max(p.kv_len[b], 0), p.Skv);
  const int n_groups = (kv_end + p.G - 1) / p.G;
  const long long k_off = b * p.k_sb + h * p.k_sh;
  const long long v_off = b * p.v_sb + h * p.v_sh;
  const float* ks_base = p.ks + b * p.ks_sb + h * p.ks_sh;
  const float* vs_base = p.vs + b * p.vs_sb + h * p.vs_sh;

  auto group_tiles = [&](int grp) {
    return (min(grp * p.G + p.G, kv_end) - grp * p.G + kTile - 1) / kTile;
  };
  auto advance = [&](Cursor c) {
    if (++c.t == group_tiles(c.g)) {
      c.t = 0;
      if (++c.pass == kPasses) {
        c.pass = 0;
        ++c.g;
      }
    }
    return c;
  };
  auto load = [&](const Cursor& c, int buf) {
    const int base = c.g * p.G + c.t * kTile;
    int8_t* dk = sKraw + buf * kRaw;
    int8_t* dv = sVraw + buf * kRaw;
    const bool want_v = c.pass == kPasses - 1;
#pragma unroll
    for (int i = 0; i < kRaw / 16 / kThreads; ++i) {
      const int cidx = tid + i * kThreads;
      const int row = cidx >> 3, chunk = cidx & 7;
      const bool ok = base + row < kv_end;
      const long long tok = ok ? base + row : 0;
      // mode 0 reads k with ldmatrix straight from this tile (swizzled);
      // mode 1 widens it first (unswizzled rows)
      cp_async16(dk + (kMode == 0 ? swz8(row, chunk) : row * 128 + chunk * 16),
                 p.k + k_off + tok * p.k_ss + chunk * 16, ok);
      if (want_v)
        cp_async16(dv + row * 128 + chunk * 16, p.v + v_off + tok * p.v_ss + chunk * 16, ok);
    }
    if (tid < kTile) {
      const bool ok = base + tid < kv_end;
      const long long tok = ok ? base + tid : 0;
      float* ds = sScale + buf * 2 * kTile;
      cp_async4(ds + tid, ks_base + tok * p.ks_ss, ok);
      cp_async4(ds + kTile + tid, vs_base + tok * p.vs_ss, ok);
    }
  };

  Cursor cur{0, 0, 0};
  if (n_groups > 0) load(cur, 0);
  cp_async_commit();

  // q fragments, kept in registers for the whole walk
  uint32_t qf[kMode == 0 ? 4 : 8][4];
  float qs0 = 0.f, qs1 = 0.f;
  if constexpr (kMode == 0) {
    const int8_t* qbase = static_cast<const int8_t*>(p.q) + b * p.q_sb + h * p.q_sh;
#pragma unroll
    for (int i = 0; i < kRaw / 16 / kThreads; ++i) {
      const int cidx = tid + i * kThreads;
      const int row = cidx >> 3, chunk = cidx & 7;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < p.Sq)
        val = *reinterpret_cast<const uint4*>(qbase + (long long)(q0 + row) * p.q_ss + chunk * 16);
      *reinterpret_cast<uint4*>(sQ + swz8(row, chunk)) = val;
    }
    const float* qsb = p.qs + (long long)b * p.Sq * p.H + h;
    if (r0 < p.Sq) qs0 = qsb[(long long)r0 * p.H];
    if (r1 < p.Sq) qs1 = qsb[(long long)r1 * p.H];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(qf[kk], sQ + swz8(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
  } else {
    // q pre-scaled into the exp2 domain and rounded back to bf16 on the load
    const __nv_bfloat16* qbase = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    __nv_bfloat16* sQb = reinterpret_cast<__nv_bfloat16*>(sQ);
#pragma unroll
    for (int i = 0; i < 2 * kRaw / 16 / kThreads; ++i) {
      const int cidx = tid + i * kThreads;
      const int row = cidx >> 4, col = (cidx & 15) << 3;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < p.Sq) {
        val = *reinterpret_cast<const uint4*>(qbase + (long long)(q0 + row) * p.q_ss + col);
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          h2[j] = __floats2bfloat162_rn(__fmul_rn(f.x, p.q_scale), __fmul_rn(f.y, p.q_scale));
        }
      }
      *reinterpret_cast<uint4*>(sQb + swz_bf16(row, col)) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
      ldsm_x4(qf[kc], sQb + swz_bf16(warp * 16 + (lane & 15), kc * 16 + (lane >> 4) * 8));
  }

  float o[16][4];
  int oi[16][4];  // the group's int32 PV sums
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[dt][e] = 0.f;
      oi[dt][e] = 0;
    }
  float m_r[2] = {kNegInf, kNegInf};       // running max (after the group's pass 1)
  float l_r[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  float gmax[2] = {kNegInf, kNegInf};      // pass 1: the group's logit max
  float lsum[2] = {0.f, 0.f};              // the group's sum of p
  float pvmax[2] = {0.f, 0.f};             // mode 0: the group's max p * vs
  float mult[2] = {0.f, 0.f}, deq[2] = {0.f, 0.f};  // mode 0, by row
  float inv127 = 0.f, deq_g = 0.f;         // mode 1, the group's

  int buf = 0;
  while (cur.g < n_groups) {
    const Cursor nxt = advance(cur);
    if (nxt.g < n_groups) load(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const bool last = cur.pass == kPasses - 1;
    const int tile_base = cur.g * p.G + cur.t * kTile;
    if constexpr (kMode == 1) {
      if (cur.pass == 0 && cur.t == 0) {
        // the group's max v scale over every key of the group in the cache
        float mx = 0.f;
        const int g0 = cur.g * p.G, g1 = min(g0 + p.G, p.Skv);
        for (int j = g0 + tid; j < g1; j += kThreads) mx = fmaxf(mx, vs_base[j * p.vs_ss]);
        sRed[tid] = mx;
      }
      // widen the int8 k tile into the swizzled bf16 tile
      const int8_t* rk = sKraw + buf * kRaw;
#pragma unroll
      for (int i = 0; i < kRaw / 16 / kThreads; ++i) {
        const int cidx = tid + i * kThreads;
        const int row = cidx >> 3, col = (cidx & 7) << 4;
        const uint4 raw = *reinterpret_cast<const uint4*>(rk + row * 128 + col);
        const uint2 a = widen4(raw.x), bb = widen4(raw.y), cc = widen4(raw.z), d = widen4(raw.w);
        *reinterpret_cast<uint4*>(sKw + swz_bf16(row, col)) = make_uint4(a.x, a.y, bb.x, bb.y);
        *reinterpret_cast<uint4*>(sKw + swz_bf16(row, col + 8)) = make_uint4(cc.x, cc.y, d.x, d.y);
      }
    }
    if (last) {
      // transpose the v tile: Vt[d][key'] with key' the fragment order
      // (within a 32-key chunk, key' = 16*half + 4*t + c holds key
      // 16*half + 8*(c >> 1) + 2*t + (c & 1))
      const uint8_t* rv = reinterpret_cast<const uint8_t*>(sVraw + buf * kRaw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // 16 key groups x 32 d groups; a warp reads one key group's 32
        // consecutive words of each of its 4 rows (no bank conflict)
        const int blk = tid + i * kThreads;
        const int kg = blk >> 5, d0 = (blk & 31) * 4;
        const int kc = kg >> 3, half = (kg >> 2) & 1, t = kg & 3;
        const int key0 = kc * 32 + half * 16 + 2 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rv + key0 * 128 + d0);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rv + (key0 + 1) * 128 + d0);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rv + (key0 + 8) * 128 + d0);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rv + (key0 + 9) * 128 + d0);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        const int col = kc * 32 + half * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(sVt + swz_vt(d0, col)) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(sVt + swz_vt(d0 + 1, col)) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(sVt + swz_vt(d0 + 2, col)) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(sVt + swz_vt(d0 + 3, col)) = __byte_perm(hi01, hi23, 0x7632);
      }
    }
    if (kMode == 1 || last) __syncthreads();
    if constexpr (kMode == 1) {
      if (last && cur.t == 0) {
        float vsb = 0.f;
        for (int j = 0; j < kThreads; ++j) vsb = fmaxf(vsb, sRed[j]);
        vsb = fmaxf(vsb, 1e-20f);
        inv127 = __fdiv_rn(127.f, vsb);
        deq_g = __fdiv_rn(vsb, 127.f);
      }
    }

    const float* cks = sScale + buf * 2 * kTile;
    const float* cvs = cks + kTile;

    // s = the exp2-domain logits of this warp's 16 rows x 64 keys
    float s[8][4];
    if constexpr (kMode == 0) {
      int si[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
      const int8_t* cK = sKraw + buf * kRaw;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, cK + swz8(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 2 + ((lane >> 3) & 1)));
          mma_s8(si[2 * np], qf[kk], kb[0], kb[1]);
          mma_s8(si[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float k0 = cks[nt * 8 + 2 * t4], k1 = cks[nt * 8 + 2 * t4 + 1];
        s[nt][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][0]), qs0), k0);
        s[nt][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][1]), qs0), k1);
        s[nt][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][2]), qs1), k0);
        s[nt][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[nt][3]), qs1), k1);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, sKw + swz_bf16(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     kc * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np], qf[kc], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kc], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float k0 = cks[nt * 8 + 2 * t4], k1 = cks[nt * 8 + 2 * t4 + 1];
        s[nt][0] = __fmul_rn(s[nt][0], k0); s[nt][1] = __fmul_rn(s[nt][1], k1);
        s[nt][2] = __fmul_rn(s[nt][2], k0); s[nt][3] = __fmul_rn(s[nt][3], k1);
      }
    }
    if (tile_base + kTile > kv_end) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tile_base + nt * 8 + 2 * t4 + (e & 1) >= kv_end) s[nt][e] = kNegInf;
    }

    const bool tile_last = cur.t == group_tiles(cur.g) - 1;
    if (cur.pass == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        gmax[0] = fmaxf(gmax[0], fmaxf(s[nt][0], s[nt][1]));
        gmax[1] = fmaxf(gmax[1], fmaxf(s[nt][2], s[nt][3]));
      }
      if (tile_last) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_r[r], quad_max(gmax[r]));
          corr[r] = exp2f(m_r[r] - m_new);
          m_r[r] = m_new;
          gmax[r] = kNegInf;
        }
      }
    } else if (kMode == 0 && !last) {
      // mode 0, pass 2: l and the group's row max of p * vs
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float v0 = cvs[nt * 8 + 2 * t4], v1 = cvs[nt * 8 + 2 * t4 + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[nt][e] - m_r[e >> 1]);
          lsum[e >> 1] += pe;
          pvmax[e >> 1] = fmaxf(pvmax[e >> 1], __fmul_rn(pe, (e & 1) ? v1 : v0));
        }
      }
      if (tile_last) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float rmax = fmaxf(quad_max(pvmax[r]), 1e-20f);
          mult[r] = __fdiv_rn(127.f, rmax);
          deq[r] = __fdiv_rn(rmax, 127.f);
          pvmax[r] = 0.f;
        }
      }
    }
    if (last) {
      // codes, straight from the logit fragment into the PV A fragment
      int c[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float v0 = cvs[nt * 8 + 2 * t4], v1 = cvs[nt * 8 + 2 * t4 + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pe = exp2f(s[nt][e] - m_r[r]);
          const float vse = (e & 1) ? v1 : v0;
          float u;
          if constexpr (kMode == 0) {
            u = __fmul_rn(__fmul_rn(pe, vse), mult[r]);
          } else {
            lsum[r] += pe;
            u = __fmul_rn(pe, __fmul_rn(vse, inv127));
          }
          c[nt][e] = __float2int_rn(u);
        }
      }
      if (p.codes != nullptr) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1;
            const int key = tile_base + nt * 8 + 2 * t4 + (e & 1);
            if (row < p.Sq && key < kv_end)
              p.codes[((long long)bh * p.Sq + row) * p.Skv + key] = static_cast<uint8_t>(c[nt][e]);
          }
      }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const int n = 4 * kc;
        const uint32_t pa[4] = {
            pack4(c[n][0], c[n][1], c[n + 1][0], c[n + 1][1]),
            pack4(c[n][2], c[n][3], c[n + 1][2], c[n + 1][3]),
            pack4(c[n + 2][0], c[n + 2][1], c[n + 3][0], c[n + 3][1]),
            pack4(c[n + 2][2], c[n + 2][3], c[n + 3][2], c[n + 3][3])};
#pragma unroll
        for (int dp = 0; dp < 8; ++dp) {
          uint32_t vb[4];
          ldsm_x4(vb, sVt + swz_vt(dp * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   kc * 32 + ((lane >> 3) & 1) * 16));
          mma_s8(oi[2 * dp], pa, vb[0], vb[1]);
          mma_s8(oi[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
      if (tile_last) {
        // fold the group: l = l * corr + sum p; acc = acc * corr + f32(sum) * deq
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_r[r] = __fadd_rn(__fmul_rn(l_r[r], corr[r]), quad_sum(lsum[r]));
          lsum[r] = 0.f;
        }
#pragma unroll
        for (int dt = 0; dt < 16; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dq = kMode == 0 ? deq[e >> 1] : deq_g;
            o[dt][e] = __fadd_rn(__fmul_rn(o[dt][e], corr[e >> 1]),
                                 __fmul_rn(__int2float_rn(oi[dt][e]), dq));
            oi[dt][e] = 0;
          }
      }
    }
    __syncthreads();  // these buffers are refilled by the next step
    cur = nxt;
    buf ^= 1;
  }

  const float d0 = fmaxf(l_r[0], 1e-30f), d1 = fmaxf(l_r[1], 1e-30f);
  __nv_bfloat16* obase = p.out + ((long long)b * p.Sq * p.H + h) * kHeadDim;
  const long long o_ss = (long long)p.H * kHeadDim;
  if (r0 < p.Sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(obase + r0 * o_ss);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      dst[dt * 4 + t4] = pack_bf16(__fdiv_rn(o[dt][0], d0), __fdiv_rn(o[dt][1], d0));
  }
  if (r1 < p.Sq) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(obase + r1 * o_ss);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      dst[dt * 4 + t4] = pack_bf16(__fdiv_rn(o[dt][2], d1), __fdiv_rn(o[dt][3], d1));
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + (long long)bh * p.Sq;
    if (r0 < p.Sq) lse[r0] = __fdiv_rn(__fadd_rn(m_r[0], log2f(d0)), kLog2e);
    if (r1 < p.Sq) lse[r1] = __fdiv_rn(__fadd_rn(m_r[1], log2f(d1)), kLog2e);
  }
}

template <int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(kMode);
  cudaError_t err = cudaFuncSetAttribute(
      flash_quant_ext_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_quant_ext_kernel<kMode><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// mode 0: int8 QK (q int8 + q_scale), mode 1: bf16 QK (q bf16). out is a
// contiguous [B, Sq, H, 128] bf16 tensor.
extern "C" int inferix_flash_attention_quant_ext(
    const void* q, const void* q_scale, const void* k, const void* v,
    const void* k_scale, const void* v_scale, void* out, void* lse,
    const void* kv_len, void* codes, int B, int H, int Sq, int Skv, int G,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long ks_sb, long long ks_ss, long long ks_sh,
    long long vs_sb, long long vs_ss, long long vs_sh,
    float q_scale_f, int mode, void* stream) {
  if (G <= 0 || G % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.qs = static_cast<const float*>(q_scale);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.kv_len = static_cast<const int*>(kv_len);
  p.codes = static_cast<uint8_t*>(codes);
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.ks_sb = ks_sb; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
  p.vs_sb = vs_sb; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
  p.q_scale = q_scale_f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return static_cast<int>(launch<0>(p, s));
  if (mode == 1) return static_cast<int>(launch<1>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
