// Multi-head attention over a packed QKV tensor with int8 score and PV
// products, in three variants (K4).
//
// Replaces the TPU kernel benchmarks/probe_int8_attention.py::_kernel
// (reached through _attn's pl.pallas_call). Same function: per batch row b
// and head h, with q, k, v the column slices [h*d, D+h*d, 2D+h*d] + [0, d)
// of qkv[b] ([L, 3D] bf16, row stride 3D) and an additive fp32 [L, L] mask:
//   fp32_scores  s = bf16(q * bf16(scale)) k^T + mask (fp32 sums);
//                out = bf16(p) v (fp32 sums), p = softmax(s)
//   int8_qk      qi, sq = quant_rows(q * scale), ki, sk = quant_rows(k),
//                s = int(qi ki^T) * (sq * sk^T) + mask; out as above
//   int8_qk_pv   as int8_qk, then pi = round(p * 127) (p normalised),
//                vi = round(v / sv), sv = max_L |v| / 127 + 1e-30 per
//                column; out = int(pi vi) * (sv / 127)
// with quant_rows(x) = (round(x / s), s = max_d |x| / 127 + 1e-30),
// rounding half to even, out cast to bf16 (ops/int8_attention.py has the
// plain version, operation for operation).
//
// What bounds it on an H100 SXM: bytes. At the probe's shape (B 256, L 208,
// D 768, H 12: the batch-256 ViT-B/16 serving attention) a call moves qkv
// 245.4 MB + mask 0.17 MB + out 81.8 MB = 327.3 MB, 97.7 us at 3.35 TB/s,
// against 4 B H L^2 d = 34.0 G operations, 34.4 us at the bf16 tensor-core
// peak and 17.2 us at the int8 one. What the design does about it: qkv is
// read from device memory once, in place (no head transposes, no padded
// copy); the [L, L] scores, the quantized q, k, p and v never leave the SM;
// the output is written once, straight into its head's columns. A block
// reads its head's k and v more than once, but from L2 (the four query
// tiles of one (b, h) share them).
//
// Unlike the TPU kernel, which holds one whole [L, 3D] row in VMEM and
// loops over heads, a block owns one tile of 64 queries of one head (grid:
// query tiles x heads x batch, 4 warps x 16 rows) and streams the keys in
// tiles of 64 through shared memory. int8_qk_pv rounds the NORMALISED p, so
// the online softmax of K1 cannot give its pi: every variant makes two
// passes over the keys, the first for each row's max and sum (online), the
// second recomputing the scores (the same products, the same values) to
// form p = exp(s - max) / sum, then P.V. fp32_scores and int8_qk take the
// same two passes, so the variants compare like with like.
//
// Products, all through mma.sync (no wgmma/TMA yet):
// - QK^T in bf16 (fp32_scores): m16n8k16, q's A fragments held in
//   registers, k's B fragments from a bf16 tile in shared memory (K1's).
// - QK^T in int8: m16n8k32.s8, q quantized once per block and k once per
//   tile on the way into shared memory (2 threads per row: a shuffle gives
//   the row max), scales kept beside them; the B operand is k's rows, the
//   layout it wants. int32 sums are exact (d 127^2 < 2^24).
// - P.V in bf16: K1's repacking of the score fragments as A, v's B
//   fragments from ldmatrix.trans.
// - P.V in int8: m16n8k32.s8 with the score fragments repacked as A. A
//   thread holds keys (2t, 2t+1, 2t+8, 2t+9) of each 16 for its rows, which
//   the mma reads as k positions (4t .. 4t+3): any permutation of k applied
//   to both operands leaves an integer sum unchanged, so the v tile is
//   stored transposed ([d][key], 4 keys of one column per 32-bit word, as
//   the s8 B operand wants and ldmatrix.trans cannot give for bytes) in
//   that permuted order, quantized on its way in from a bf16 staging tile.
//   sv, a max over all L keys of the head, is reduced by the block before
//   any tile. int32 sums are exact (L 127^2 < 2^24 for L <= 1024).
// - Keys past L (the last tile's ragged edge) are zeros in shared memory
//   and get p = 0; no padded copy is made. Query rows past L are computed
//   and never stored.
//
// Build without --use_fast_math (ops/build.py): every x / s is an IEEE
// division, every rounding half to even (__float2int_rn), and the scale
// products and sums use __fmul_rn / __fadd_rn so that nvcc does not
// contract them into FMAs, so the int8 values and the scores are the plain
// version's bit for bit.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Variant { FP32_SCORES = 0, INT8_QK = 1, INT8_QK_PV = 2 };

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int PAD = 8;          // bf16 per row of a bf16 tile: no conflicts
constexpr int VT_ROW = BK + 16; // bytes per row of the transposed int8 v

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 4 int8 values, the first in the lowest byte
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return uint32_t(uint8_t(a)) | (uint32_t(uint8_t(b)) << 8) |
         (uint32_t(uint8_t(c)) << 16) | (uint32_t(uint8_t(d)) << 24);
}

// round(x / s), half to even
__device__ __forceinline__ int quant(float x, float s) {
  return __float2int_rn(__fdiv_rn(x, s));
}

// K1's: four transposed 8x8 bf16 matrices (the B fragments of a row-major
// [k][n] tile)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Per-row int8 quantization of 64 rows [row0, row0 + 64) of a bf16 slice
// (row stride `stride`; rows at or past `rows` read as zeros), x = the bf16
// value times `mul` in fp32 when `scaled`: s = max|x| / 127 + 1e-30 into
// scales[r], round(x / s) into dst (row stride HD + 16 bytes). Two threads
// per row, HD / 2 values each; all THREADS threads take part.
template <int HD>
__device__ __forceinline__ void quantize_tile(const __nv_bfloat16* src,
                                              long long stride, int row0,
                                              int rows, float mul, bool scaled,
                                              int8_t* dst, float* scales) {
  constexpr int HALF = HD / 2;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = row0 + r;
  float x[HALF];
  if (row < rows) {
    const __nv_bfloat16* p = src + row * stride + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        x[i + 2 * j] = f.x;
        x[i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < HALF; ++i) x[i] = 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    if (scaled) x[i] = __fmul_rn(x[i], mul);
    m = fmaxf(m, fabsf(x[i]));
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  const float s = __fadd_rn(__fdiv_rn(m, 127.f), 1e-30f);
  uint32_t* out =
      reinterpret_cast<uint32_t*>(dst + r * (HD + 16) + half * HALF);
#pragma unroll
  for (int i = 0; i < HALF; i += 4)
    out[i / 4] = pack_s8(quant(x[i], s), quant(x[i + 1], s),
                         quant(x[i + 2], s), quant(x[i + 3], s));
  if (half == 0) scales[r] = s;
}

// Fragment layouts (PTX ISA): g = lane / 4, t = lane % 4. m16n8k16 bf16:
// A a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// B b0 (k 2t..2t+1, n g), b1 (k 2t+8..). m16n8k32 s8: A a0 (g, 4t..4t+3),
// a1 (g+8, ..), a2 (g, 16+4t..), a3 (g+8, 16+4t..); B b0 (k 4t..4t+3, n g),
// b1 (k 16+4t..). C (both): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, ..).
template <int HD, int VAR>
__global__ void __launch_bounds__(THREADS)
    int8_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int L, int D,
                          float scale) {
  constexpr bool QK8 = VAR != FP32_SCORES;
  constexpr bool PV8 = VAR == INT8_QK_PV;
  constexpr int KROW = HD + 16;  // bytes per row of the int8 q and k tiles
  __shared__ __align__(16) int8_t qs8[QK8 ? BQ * KROW : 16];
  __shared__ __align__(16) int8_t ks8[QK8 ? BK * KROW : 16];
  __shared__ float sq[BQ], sk[BK];
  __shared__ __align__(16) __nv_bfloat16 ks[QK8 ? 1 : BK][HD + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK][HD + PAD];
  __shared__ __align__(16) int8_t vt8[PV8 ? HD * VT_ROW : 16];
  __shared__ float svs[PV8 ? HD : 1];
  // mask tile; a row stride of 8 (mod 32) words keeps the float2 reads
  // below free of bank conflicts
  __shared__ __align__(16) float ms[BQ][BK + 8];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_blk = blockIdx.x * BQ;
  const int r0 = q_blk + warp * 16 + g;  // this thread's rows: r0 and r1
  const int r1 = r0 + 8;
  const bool active = q_blk + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const __nv_bfloat16* qb = base + h * HD;
  const __nv_bfloat16* kb = base + D + h * HD;
  const __nv_bfloat16* vb = base + 2 * D + h * HD;

  if constexpr (PV8) {
    // sv: each column's max |v| over all L keys, before any P.V tile
    const int c = tid % HD;
    float m = 0.f;
    for (int key = tid / HD; key < L; key += THREADS / HD)
      m = fmaxf(m, fabsf(__bfloat162float(vb[key * stride + c])));
    float* part = &ms[0][0];
    part[tid] = m;
    __syncthreads();
    if (tid < HD) {
      for (int j = tid + HD; j < THREADS; j += HD) m = fmaxf(m, part[j]);
      svs[tid] = __fadd_rn(__fdiv_rn(m, 127.f), 1e-30f);
    }
  }

  // q's A fragments, held for the whole block
  uint32_t qa[QK8 ? HD / 32 : HD / 16][4];
  float sq0 = 0.f, sq1 = 0.f;
  if constexpr (QK8) {
    quantize_tile<HD>(qb, stride, q_blk, L, scale, true, qs8, sq);
    __syncthreads();  // also publishes svs and frees ms
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
      const int8_t* p = qs8 + (warp * 16 + g) * KROW + kk * 32 + 4 * t;
      qa[kk][0] = ld_u32(p);
      qa[kk][1] = ld_u32(p + 8 * KROW);
      qa[kk][2] = ld_u32(p + 16);
      qa[kk][3] = ld_u32(p + 8 * KROW + 16);
    }
    sq0 = sq[warp * 16 + g];
    sq1 = sq[warp * 16 + g + 8];
  } else {
    // q * scale in bf16, as the JAX code: the scale rounded to bf16, the
    // product (exact in fp32) rounded once
    const float sc = __bfloat162float(__float2bfloat16_rn(scale));
    auto scaled = [sc](uint32_t pair) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pair));
      return pack_bf16(__fmul_rn(f.x, sc), __fmul_rn(f.y, sc));
    };
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = r0 < L ? scaled(ld_pair(qb + r0 * stride + c)) : 0u;
      qa[kk][1] = r1 < L ? scaled(ld_pair(qb + r1 * stride + c)) : 0u;
      qa[kk][2] = r0 < L ? scaled(ld_pair(qb + r0 * stride + c + 8)) : 0u;
      qa[kk][3] = r1 < L ? scaled(ld_pair(qb + r1 * stride + c + 8)) : 0u;
    }
  }

  // k (and v) tile at key k0 into shared memory, with the mask tile
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is consumed
    if constexpr (QK8) {
      quantize_tile<HD>(kb, stride, k0, L, 1.f, false, ks8, sk);
    } else {
      for (int i = tid; i < BK * HD / 8; i += THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, key = k0 + r;
        uint4 kv = make_uint4(0, 0, 0, 0);
        if (key < L) kv = *reinterpret_cast<const uint4*>(kb + key * stride + c);
        *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      }
    }
    if (with_v) {
      for (int i = tid; i < BK * HD / 8; i += THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, key = k0 + r;
        uint4 vv = make_uint4(0, 0, 0, 0);
        if (key < L) vv = *reinterpret_cast<const uint4*>(vb + key * stride + c);
        *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
      }
    }
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, row = q_blk + r, key = k0 + c;
      ms[r][c] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    __syncthreads();
    if constexpr (PV8) {
      if (with_v) {
        // v quantized per column and transposed, k positions permuted as
        // the P.V mma reads them: word kb4 of row c holds keys
        // 16 (kb4 / 4) + 2 (kb4 % 4) + {0, 1, 8, 9}
        for (int i = tid; i < HD * (BK / 4); i += THREADS) {
          const int kb4 = i % (BK / 4), c = i / (BK / 4);
          const int key = (kb4 / 4) * 16 + 2 * (kb4 % 4);
          const float sv = svs[c];
          *reinterpret_cast<uint32_t*>(vt8 + c * VT_ROW + kb4 * 4) =
              pack_s8(quant(__bfloat162float(vs[key][c]), sv),
                      quant(__bfloat162float(vs[key + 1][c]), sv),
                      quant(__bfloat162float(vs[key + 8][c]), sv),
                      quant(__bfloat162float(vs[key + 9][c]), sv));
        }
        __syncthreads();
      }
    }
  };

  // the scores of this thread's rows against the tile's keys; keys past L
  // get -inf (no weight)
  auto scores = [&](int k0, float (&s)[BK / 8][4]) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      if constexpr (QK8) {
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          const int8_t* p = ks8 + (n * 8 + g) * KROW + kk * 32 + 4 * t;
          mma_s8(acc, qa[kk], ld_u32(p), ld_u32(p + 16));
        }
        const float sk0 = sk[n * 8 + 2 * t], sk1 = sk[n * 8 + 2 * t + 1];
        // si * (sq * sk), in that order
        s[n][0] = __fmul_rn(float(acc[0]), __fmul_rn(sq0, sk0));
        s[n][1] = __fmul_rn(float(acc[1]), __fmul_rn(sq0, sk1));
        s[n][2] = __fmul_rn(float(acc[2]), __fmul_rn(sq1, sk0));
        s[n][3] = __fmul_rn(float(acc[3]), __fmul_rn(sq1, sk1));
      } else {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma_bf16(s[n], qa[kk], ld_pair(&ks[n * 8 + g][kk * 16 + 2 * t]),
                   ld_pair(&ks[n * 8 + g][kk * 16 + 2 * t + 8]));
      }
      const int c = n * 8 + 2 * t;
      const float2 m0 = *reinterpret_cast<const float2*>(&ms[warp * 16 + g][c]);
      const float2 m1 =
          *reinterpret_cast<const float2*>(&ms[warp * 16 + g + 8][c]);
      const float mk[4] = {m0.x, m0.y, m1.x, m1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = k0 + c + (e & 1) < L ? __fadd_rn(s[n][e], mk[e]) : -INFINITY;
    }
  };

  // pass 1: each row's max and sum of exp(s - max), online over the tiles
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += BK) {
    load_tile(k0, false);
    if (!active) continue;
    float s[BK / 8][4];
    scores(k0, s);
    float tmax[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e / 2] = fmaxf(tmax[e / 2], s[n][e]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a group share a row
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) rsum[e / 2] += expf(s[n][e] - m[e / 2]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
    }
  }

  // pass 2: p = exp(s - max) / sum, then P.V
  float o[HD / 8][4];
  int oi[PV8 ? HD / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[n][e] = 0.f;
      if constexpr (PV8) oi[n][e] = 0;
    }
  for (int k0 = 0; k0 < L; k0 += BK) {
    load_tile(k0, true);
    if (!active) continue;
    float s[BK / 8][4];
    scores(k0, s);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fdiv_rn(expf(s[n][e] - m[e / 2]), l[e / 2]);
    if constexpr (PV8) {
      int pi[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pi[n][e] = __float2int_rn(__fmul_rn(s[n][e], 127.f));
#pragma unroll
      for (int ks32 = 0; ks32 < BK / 32; ++ks32) {  // 32 keys per step
        const int n0 = ks32 * 4;
        const uint32_t pa[4] = {
            pack_s8(pi[n0][0], pi[n0][1], pi[n0 + 1][0], pi[n0 + 1][1]),
            pack_s8(pi[n0][2], pi[n0][3], pi[n0 + 1][2], pi[n0 + 1][3]),
            pack_s8(pi[n0 + 2][0], pi[n0 + 2][1], pi[n0 + 3][0],
                    pi[n0 + 3][1]),
            pack_s8(pi[n0 + 2][2], pi[n0 + 2][3], pi[n0 + 3][2],
                    pi[n0 + 3][3])};
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn) {
          const int8_t* p = vt8 + (dn * 8 + g) * VT_ROW + ks32 * 32 + 4 * t;
          mma_s8(oi[dn], pa, ld_u32(p), ld_u32(p + 16));
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {  // 16 keys per step
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int n = 0; n < HD / 8; n += 2) {
          uint32_t vb0, vb1, vb2, vb3;  // B fragments of d-tiles n, n+1
          ldmatrix_x4_trans(vb0, vb1, vb2, vb3,
                            &vs[kc * 16 + lane % 16][n * 8 + (lane / 16) * 8]);
          mma_bf16(o[n], pa, vb0, vb1);
          mma_bf16(o[n + 1], pa, vb2, vb3);
        }
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* ob = out + (long long)b * L * D + h * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if constexpr (PV8) {
      // oi * (sv / 127)
      const int c = n * 8 + 2 * t;
      const float f0 = __fdiv_rn(svs[c], 127.f);
      const float f1 = __fdiv_rn(svs[c + 1], 127.f);
      o[n][0] = __fmul_rn(float(oi[n][0]), f0);
      o[n][1] = __fmul_rn(float(oi[n][1]), f1);
      o[n][2] = __fmul_rn(float(oi[n][2]), f0);
      o[n][3] = __fmul_rn(float(oi[n][3]), f1);
    }
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + n * 8) =
          pack_bf16(o[n][0], o[n][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + n * 8) =
          pack_bf16(o[n][2], o[n][3]);
  }
}

template <int HD, int VAR>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B,
                   int L, int D, int H, cudaStream_t stream) {
  // the JAX code's 1.0 / d ** 0.5, in double, then as fp32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  int8_attention_kernel<HD, VAR><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask,
      static_cast<__nv_bfloat16*>(out), L, D, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_variant(const void* qkv, const float* mask, void* out,
                           int B, int L, int D, int H, int variant,
                           cudaStream_t s) {
  switch (variant) {
    case FP32_SCORES:
      return launch<HD, FP32_SCORES>(qkv, mask, out, B, L, D, H, s);
    case INT8_QK: return launch<HD, INT8_QK>(qkv, mask, out, B, L, D, H, s);
    case INT8_QK_PV:
      return launch<HD, INT8_QK_PV>(qkv, mask, out, B, L, D, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv [B, L, 3D] bfloat16 (16-byte aligned), mask [L, L] float32, out
// [B, L, D] bfloat16; all contiguous on the current device; head dim D / H
// in {32, 64}, L <= 1024; variant 0 fp32_scores, 1 int8_qk, 2 int8_qk_pv.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int int8_attention(const void* qkv, const void* mask, void* out,
                              int B, int L, int D, int H, int variant,
                              void* stream) {
  if (B < 1 || B > 65535 || L < 1 || L > 1024 || H < 1 || H > 65535 ||
      D % H != 0)
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / H) {
    case 32: return launch_variant<32>(qkv, m, out, B, L, D, H, variant, s);
    case 64: return launch_variant<64>(qkv, m, out, B, L, D, H, variant, s);
    default: return cudaErrorInvalidValue;
  }
}
