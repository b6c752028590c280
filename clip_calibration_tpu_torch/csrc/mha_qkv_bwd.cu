// Backward of the fused multi-head attention over a packed QKV tensor (K2).
//
// Replaces the TPU kernel clip_calibration_tpu/ops/pallas_attention.py::
// _mha_qkv_bwd_kernel (reached through _bwd's pl.pallas_call). Same
// function: per batch row b and head h, with q, k, v the head's column
// slices of qkv[b] ([L, 3D], row stride 3D), g the head's slice of the
// output gradient ([L, D]) and scale = 1 / sqrt(d):
//     s  = (q scale) k^T + mask           fp32
//     P  = softmax(s)                     fp32, per row
//     dv = P^T g                          P rounded to the input dtype
//     dp = g v^T                          fp32
//     ds = P o (dp - rowsum(dp o P))      fp32
//     dq = scale ds k,  dk = scale ds^T q ds rounded to the input dtype
// written packed as dqkv [B, L, 3D]: head h's dq, dk, dv at columns h*d,
// D + h*d, 2D + h*d.
//
// What bounds it on an H100 SXM: the bf16 case is memory-bound at the
// CLIP shapes. CoOp text, qkv [50, 32, 1536] H = 8: qkv + g in and dqkv
// out are 11.5 MB, 3.4 us at 3.35 TB/s, against 0.26 GFLOP, 0.26 us at
// the 989 TFLOP/s bf16 tensor-core peak. ViT-B/16 vision, [32, 208, 2304]
// H = 12: 71.6 MB (21.4 us) against 10.6 GFLOP (10.7 us). In fp32 (no
// tensor cores) the vision shape is bound by operations: 158 us at the
// 67 TFLOP/s fp32 peak. What the design does about it: q, k, v and g are
// read in place from their packed layouts, the [L, L] scores are
// recomputed on the SM and never written, and only three fp32 numbers per
// (row, head) go through device memory between the two kernels below.
//
// Like K1 (csrc/mha_qkv_fwd.cu), no block ever holds a whole [L, L] tile:
// keys and queries stream through shared memory in tiles, so any L fits
// (the TPU kernel keeps one whole [L, 3D] row and every [L, L] score block
// in VMEM; on Hopper those would exceed shared memory at ViT-L lengths).
// Two kernels, launched back to back on one stream, no atomics:
// 1. dq: a block owns a tile of query rows of one head. A first pass over
//    the key tiles computes, online, each row's softmax max m, sum l and
//    Delta = rowsum(dp o P) (rescaled with the running max as l is); it
//    stores (m, 1/l, Delta) to a small fp32 scratch [3, B, H, L]. A second
//    pass recomputes P = exp(s - m) / l and ds and accumulates dq.
// 2. dk/dv: a block owns a tile of key rows of one head and loops over the
//    query tiles, recomputing P^T and ds^T from the stored row statistics
//    and accumulating dk and dv in registers.
//
// Per input type:
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), 4 warps x 16 rows per block. The score-shaped products
//   (q k^T, g v^T, and their transposes k q^T, v g^T) take their B
//   fragments from row-major shared-memory tiles as K1's q k^T does; the
//   products that contract over keys or queries (ds k, P^T g, ds^T q)
//   re-pack the fp32 accumulator fragment as a bf16 A operand (rounding P
//   and ds to bf16 exactly where the JAX kernel casts them) and load B with
//   ldmatrix.trans, as K1's P v does.
// - fp32: one thread per row, fp32 FMAs from shared-memory tiles, so fp32
//   runs stay full fp32 (no TF32).
//
// Masks use finfo(float32).min, never -inf, as the towers build them, so a
// fully masked row stays finite. Keys past L get no weight (s = -inf);
// queries past L contribute nothing to dk and dv (P = 0 there); rows past
// L are computed and never stored. Padded keys masked for every row get
// P = 0 exactly, so their dk and dv are exact zeros.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MROWS = 16 * MMA_WARPS;  // rows a block owns
constexpr int MTILE = 64;              // rows of the streamed tile
constexpr int PAD = 8;                 // bf16 per smem row: no bank conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four transposed 8x8 bf16 matrices from shared memory (see K1): each
// thread receives, per matrix, the B fragment of a row-major [k][n] tile.
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

// A fragments of rows r0 = row0 + g and r1 = r0 + 8 of a [rows, HD] bf16
// matrix with row stride `stride`; rows at or past L read as zero.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const __nv_bfloat16* p,
                                       long long stride, int r0, int L,
                                       int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < L ? ld_pair(p + r0 * stride + c) : 0u;
    a[kk][1] = r1 < L ? ld_pair(p + r1 * stride + c) : 0u;
    a[kk][2] = r0 < L ? ld_pair(p + r0 * stride + c + 8) : 0u;
    a[kk][3] = r1 < L ? ld_pair(p + r1 * stride + c + 8) : 0u;
  }
}

// c[n] = A x T^T for the 16 rows of A and the MTILE rows of the
// shared-memory tile T ([MTILE][HD + PAD], row-major): score-shaped
// products, T's rows are the output columns.
template <int HD>
__device__ __forceinline__ void rows_x_tile(float (&c)[MTILE / 8][4],
                                            const uint32_t (&a)[HD / 16][4],
                                            const __nv_bfloat16 (*T)[HD + PAD],
                                            int g, int t) {
#pragma unroll
  for (int n = 0; n < MTILE / 8; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_bf16(c[n], a[kk], ld_pair(&T[n * 8 + g][kk * 16 + 2 * t]),
               ld_pair(&T[n * 8 + g][kk * 16 + 2 * t + 8]));
  }
}

// acc += bf16(w) x T, contracting over the MTILE rows of T: w is a
// [16, MTILE] fp32 accumulator fragment, re-packed as bf16 A operands.
template <int HD>
__device__ __forceinline__ void acc_w_x_tile(float (&acc)[HD / 8][4],
                                             const float (&w)[MTILE / 8][4],
                                             const __nv_bfloat16 (*T)[HD + PAD],
                                             int lane) {
#pragma unroll
  for (int kc = 0; kc < MTILE / 16; ++kc) {
    const uint32_t wa[4] = {pack_bf16(w[2 * kc][0], w[2 * kc][1]),
                            pack_bf16(w[2 * kc][2], w[2 * kc][3]),
                            pack_bf16(w[2 * kc + 1][0], w[2 * kc + 1][1]),
                            pack_bf16(w[2 * kc + 1][2], w[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b0, b1, b2, b3;  // B fragments of d-tiles n, n+1
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        &T[kc * 16 + lane % 16][n * 8 + (lane / 16) * 8]);
      mma_bf16(acc[n], wa, b0, b1);
      mma_bf16(acc[n + 1], wa, b2, b3);
    }
  }
}

// Stage MTILE rows [row0, row0 + MTILE) of a [L, HD] bf16 slice (row
// stride `stride`) in shared memory by 16-byte loads; rows past L as zero.
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*T)[HD + PAD],
                                           const __nv_bfloat16* p,
                                           long long stride, int row0, int L,
                                           int tid) {
  for (int i = tid; i < MTILE * HD / 8; i += MMA_WARPS * 32) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < L) v = *reinterpret_cast<const uint4*>(p + row * stride + c);
    *reinterpret_cast<uint4*>(&T[r][c]) = v;
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4.
// C 16x8: c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    mha_qkv_bwd_dq_bf16(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ grad,
                        __nv_bfloat16* __restrict__ dqkv,
                        float* __restrict__ stats, int L, int D, int H,
                        float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[MTILE][HD + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[MTILE][HD + PAD];
  __shared__ __align__(16) float ms[MROWS][MTILE + 8];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_blk = blockIdx.x * MROWS;
  const int r0 = q_blk + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bool active = q_blk + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const __nv_bfloat16* kb = base + D + h * HD;
  const __nv_bfloat16* vb = base + 2 * D + h * HD;

  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  load_a<HD>(qa, base + h * HD, stride, r0, L, t);
  load_a<HD>(ga, grad + (long long)b * L * D + h * HD, D, r0, L, t);

  auto stage = [&](int k0) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(ks, kb, stride, k0, L, tid);
    stage_rows<HD>(vs, vb, stride, k0, L, tid);
    for (int i = tid; i < MROWS * MTILE; i += MMA_WARPS * 32) {
      const int r = i / MTILE, c = i % MTILE, row = q_blk + r, key = k0 + c;
      ms[r][c] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    __syncthreads();
  };
  // s = (q k^T) scale + mask over one staged key tile; keys past L: -inf
  auto scores = [&](float (&s)[MTILE / 8][4], int k0) {
    rows_x_tile<HD>(s, qa, ks, g, t);
#pragma unroll
    for (int n = 0; n < MTILE / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 m0 = *reinterpret_cast<const float2*>(&ms[warp * 16 + g][c]);
      const float2 m1 =
          *reinterpret_cast<const float2*>(&ms[warp * 16 + g + 8][c]);
      const float mk[4] = {m0.x, m0.y, m1.x, m1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = k0 + c + (e & 1) < L ? s[n][e] * scale + mk[e] : -INFINITY;
    }
  };

  // pass 1: row statistics (online, as K1's forward)
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += MTILE) {
    stage(k0);
    if (!active) continue;
    float s[MTILE / 8][4], dp[MTILE / 8][4];
    scores(s, k0);
    rows_x_tile<HD>(dp, ga, vs, g, t);
    float tmax[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < MTILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e / 2] = fmaxf(tmax[e / 2], s[n][e]);
    float alpha[2], rsum[2] = {0.f, 0.f}, rdot[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a group share a row
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < MTILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e / 2]);
        rsum[e / 2] += p;
        rdot[e / 2] += p * dp[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      rdot[i] += __shfl_xor_sync(0xffffffffu, rdot[i], 1);
      rdot[i] += __shfl_xor_sync(0xffffffffu, rdot[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
      dsum[i] = dsum[i] * alpha[i] + rdot[i];
    }
  }
  // l >= 1: the running max itself contributes exp(0)
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  const float delta[2] = {dsum[0] * inv_l[0], dsum[1] * inv_l[1]};
  if (active && t == 0) {
    const long long bhl = (long long)gridDim.z * H * L;
    float* st = stats + ((long long)b * H + h) * L;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < L) {
        st[row] = m[i];
        st[bhl + row] = inv_l[i];
        st[2 * bhl + row] = delta[i];
      }
    }
  }

  // pass 2: dq = scale bf16(ds) k
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int k0 = 0; k0 < L; k0 += MTILE) {
    stage(k0);
    if (!active) continue;
    float s[MTILE / 8][4], dp[MTILE / 8][4];
    scores(s, k0);
    rows_x_tile<HD>(dp, ga, vs, g, t);
#pragma unroll
    for (int n = 0; n < MTILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float p = expf(s[n][e] - m[i]) * inv_l[i];
        s[n][e] = p * (dp[n][e] - delta[i]);  // ds
      }
    acc_w_x_tile<HD>(dq, s, ks, lane);
  }

  if (!active) return;
  __nv_bfloat16* ob = dqkv + (long long)b * L * stride + h * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + r0 * stride + n * 8) =
          pack_bf16(dq[n][0] * scale, dq[n][1] * scale);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * stride + n * 8) =
          pack_bf16(dq[n][2] * scale, dq[n][3] * scale);
  }
}

// dk and dv for one tile of MROWS keys; the accumulator rows are keys and
// its columns the queries of the streamed tile (s^T, dp^T, P^T, ds^T).
template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    mha_qkv_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ grad,
                          __nv_bfloat16* __restrict__ dqkv,
                          const float* __restrict__ stats, int L, int D,
                          int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[MTILE][HD + PAD];
  __shared__ __align__(16) __nv_bfloat16 gs[MTILE][HD + PAD];
  // mask tile transposed, [key][query]: the accumulator's rows are keys
  __shared__ __align__(16) float mt[MROWS][MTILE + 8];
  __shared__ float sm[MTILE], sil[MTILE], sdl[MTILE];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k_blk = blockIdx.x * MROWS;
  const int r0 = k_blk + warp * 16 + g;  // this thread's keys: r0, r0 + 8
  const bool active = k_blk + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const __nv_bfloat16* qb = base + h * HD;
  const __nv_bfloat16* gb = grad + (long long)b * L * D + h * HD;
  const long long bhl = (long long)gridDim.z * H * L;
  const float* st = stats + ((long long)b * H + h) * L;

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a<HD>(ka, base + D + h * HD, stride, r0, L, t);
  load_a<HD>(va, base + 2 * D + h * HD, stride, r0, L, t);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += MTILE) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(qs, qb, stride, q0, L, tid);
    stage_rows<HD>(gs, gb, D, q0, L, tid);
    for (int i = tid; i < MTILE * MROWS; i += MMA_WARPS * 32) {
      // read along keys (coalesced), write transposed
      const int r = i / MROWS, c = i % MROWS, row = q0 + r, key = k_blk + c;
      mt[c][r] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    for (int i = tid; i < MTILE; i += MMA_WARPS * 32) {
      const int row = q0 + i;
      sm[i] = row < L ? st[row] : 0.f;
      sil[i] = row < L ? st[bhl + row] : 0.f;
      sdl[i] = row < L ? st[2 * bhl + row] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float p[MTILE / 8][4], ds[MTILE / 8][4];
    rows_x_tile<HD>(p, ka, qs, g, t);   // s^T = k q^T
    rows_x_tile<HD>(ds, va, gs, g, t);  // dp^T = v g^T
#pragma unroll
    for (int n = 0; n < MTILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query within the tile
        const float mk = mt[warp * 16 + g + 8 * (e / 2)][c];
        const float pv =
            q0 + c < L ? expf(p[n][e] * scale + mk - sm[c]) * sil[c] : 0.f;
        p[n][e] = pv;
        ds[n][e] = pv * (ds[n][e] - sdl[c]);
      }
    acc_w_x_tile<HD>(dv, p, gs, lane);   // dv += bf16(P)^T g
    acc_w_x_tile<HD>(dk, ds, qs, lane);  // dk += bf16(ds)^T q
  }

  if (!active) return;
  __nv_bfloat16* kout = dqkv + (long long)b * L * stride + D + h * HD + 2 * t;
  __nv_bfloat16* vout = kout + D;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < L) {
      *reinterpret_cast<uint32_t*>(kout + r0 * stride + n * 8) =
          pack_bf16(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vout + r0 * stride + n * 8) =
          pack_bf16(dv[n][0], dv[n][1]);
    }
    if (r0 + 8 < L) {
      *reinterpret_cast<uint32_t*>(kout + (r0 + 8) * stride + n * 8) =
          pack_bf16(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vout + (r0 + 8) * stride + n * 8) =
          pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA kernels, one thread per row
// ---------------------------------------------------------------------------

// shared memory at HD = 64: 45.8 KB a block, under the 48 KB of static
// shared memory
constexpr int BR = 64;  // rows a block owns, one thread each
constexpr int BT = 16;  // rows of the streamed tile

template <int HD>
__global__ void __launch_bounds__(BR)
    mha_qkv_bwd_dq_f32(const float* __restrict__ qkv,
                       const float* __restrict__ mask,
                       const float* __restrict__ grad,
                       float* __restrict__ dqkv, float* __restrict__ stats,
                       int L, int D, int H, float scale) {
  __shared__ float qs[BR][HD + 1];  // +1: no bank conflicts on row access
  __shared__ float gs[BR][HD + 1];
  __shared__ float ks[BT][HD];
  __shared__ float vs[BT][HD];
  __shared__ float ms[BR][BT + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + tid;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const float* qb = base + h * HD;
  const float* kb = base + D + h * HD;
  const float* vb = base + 2 * D + h * HD;
  const float* gb = grad + (long long)b * L * D + h * HD;

  for (int i = tid; i < BR * HD; i += BR) {
    const int r = i / HD, c = i % HD, rr = q0 + r;
    qs[r][c] = rr < L ? qb[rr * stride + c] : 0.f;
    gs[r][c] = rr < L ? gb[(long long)rr * D + c] : 0.f;
  }

  auto stage = [&](int k0) {
    __syncthreads();  // the previous tile is consumed (and qs, gs written)
    for (int i = tid; i < BT * HD; i += BR) {
      const int r = i / HD, c = i % HD, key = k0 + r;
      ks[r][c] = key < L ? kb[key * stride + c] : 0.f;
      vs[r][c] = key < L ? vb[key * stride + c] : 0.f;
    }
    for (int i = tid; i < BR * BT; i += BR) {
      const int r = i / BT, c = i % BT, rr = q0 + r, key = k0 + c;
      ms[r][c] = (rr < L && key < L) ? mask[(long long)rr * L + key] : 0.f;
    }
    __syncthreads();
  };
  // s[j] = (q k_j) scale + mask, dp[j] = g v_j over one staged key tile
  auto scores = [&](float (&s)[BT], float (&dp)[BT], int k0) {
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        sd = fmaf(qs[tid][c], ks[j][c], sd);
        pd = fmaf(gs[tid][c], vs[j][c], pd);
      }
      s[j] = k0 + j < L ? sd * scale + ms[tid][j] : -INFINITY;
      dp[j] = pd;
    }
  };

  float m = -FLT_MAX, l = 0.f, dsum = 0.f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    stage(k0);
    float s[BT], dp[BT];
    scores(s, dp, k0);
    float tmax = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < BT; ++j) tmax = fmaxf(tmax, s[j]);
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float rsum = 0.f, rdot = 0.f;
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const float p = expf(s[j] - m_new);
      rsum += p;
      rdot = fmaf(p, dp[j], rdot);
    }
    l = l * alpha + rsum;
    dsum = dsum * alpha + rdot;
    m = m_new;
  }
  const float inv_l = 1.f / l;  // l >= 1
  const float delta = dsum * inv_l;
  if (row < L) {
    const long long bhl = (long long)gridDim.z * H * L;
    float* st = stats + ((long long)b * H + h) * L;
    st[row] = m;
    st[bhl + row] = inv_l;
    st[2 * bhl + row] = delta;
  }

  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    stage(k0);
    float s[BT], dp[BT];
    scores(s, dp, k0);
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const float ds = expf(s[j] - m) * inv_l * (dp[j] - delta);
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] = fmaf(ds, ks[j][c], acc[c]);
    }
  }

  __syncthreads();
#pragma unroll
  for (int c = 0; c < HD; ++c) qs[tid][c] = acc[c] * scale;
  __syncthreads();
  float* ob = dqkv + (long long)b * L * stride + h * HD;
  for (int i = tid; i < BR * HD; i += BR) {
    const int r = i / HD, c = i % HD, rr = q0 + r;
    if (rr < L) ob[rr * stride + c] = qs[r][c];
  }
}

template <int HD>
__global__ void __launch_bounds__(BR)
    mha_qkv_bwd_dkdv_f32(const float* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const float* __restrict__ grad,
                         float* __restrict__ dqkv,
                         const float* __restrict__ stats, int L, int D, int H,
                         float scale) {
  __shared__ float kvs[2][BR][HD + 1];  // this block's k and v rows; then
                                        // its dk and dv on the way out
  __shared__ float qs[BT][HD];
  __shared__ float gs[BT][HD];
  __shared__ float mt[BT][BR + 1];  // [query][key]
  __shared__ float sm[BT], sil[BT], sdl[BT];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const float* qb = base + h * HD;
  const float* gb = grad + (long long)b * L * D + h * HD;
  const long long bhl = (long long)gridDim.z * H * L;
  const float* st = stats + ((long long)b * H + h) * L;

  for (int i = tid; i < BR * HD; i += BR) {
    const int r = i / HD, c = i % HD, key = k0 + r;
    kvs[0][r][c] = key < L ? base[key * stride + D + h * HD + c] : 0.f;
    kvs[1][r][c] = key < L ? base[key * stride + 2 * D + h * HD + c] : 0.f;
  }

  float dk[HD], dv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous tile is consumed (and kvs written)
    for (int i = tid; i < BT * HD; i += BR) {
      const int r = i / HD, c = i % HD, row = q0 + r;
      qs[r][c] = row < L ? qb[row * stride + c] : 0.f;
      gs[r][c] = row < L ? gb[(long long)row * D + c] : 0.f;
    }
    for (int i = tid; i < BT * BR; i += BR) {
      const int r = i / BR, c = i % BR, row = q0 + r, key = k0 + c;
      mt[r][c] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    if (tid < BT) {
      const int row = q0 + tid;
      sm[tid] = row < L ? st[row] : 0.f;
      sil[tid] = row < L ? st[bhl + row] : 0.f;
      sdl[tid] = row < L ? st[2 * bhl + row] : 0.f;
    }
    __syncthreads();

    const int nq = min(BT, L - q0);
    for (int i = 0; i < nq; ++i) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        sd = fmaf(kvs[0][tid][c], qs[i][c], sd);
        pd = fmaf(kvs[1][tid][c], gs[i][c], pd);
      }
      const float p = expf(sd * scale + mt[i][tid] - sm[i]) * sil[i];
      const float ds = p * (pd - sdl[i]);
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        dv[c] = fmaf(p, gs[i][c], dv[c]);
        dk[c] = fmaf(ds, qs[i][c], dk[c]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    kvs[0][tid][c] = dk[c] * scale;
    kvs[1][tid][c] = dv[c];
  }
  __syncthreads();
  float* ob = dqkv + (long long)b * L * stride + h * HD;
  for (int i = tid; i < BR * HD; i += BR) {
    const int r = i / HD, c = i % HD, key = k0 + r;
    if (key < L) {
      ob[key * stride + D + c] = kvs[0][r][c];
      ob[key * stride + 2 * D + c] = kvs[1][r][c];
    }
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const float* mask, const void* grad,
                   void* dqkv, float* stats, int B, int L, int D, int H,
                   int dtype, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const dim3 grid((L + MROWS - 1) / MROWS, H, B);
    mha_qkv_bwd_dq_bf16<HD><<<grid, MMA_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(qkv), mask, static_cast<const T*>(grad),
        static_cast<T*>(dqkv), stats, L, D, H, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mha_qkv_bwd_dkdv_bf16<HD><<<grid, MMA_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(qkv), mask, static_cast<const T*>(grad),
        static_cast<T*>(dqkv), stats, L, D, H, scale);
  } else {
    const dim3 grid((L + BR - 1) / BR, H, B);
    mha_qkv_bwd_dq_f32<HD><<<grid, BR, 0, stream>>>(
        static_cast<const float*>(qkv), mask,
        static_cast<const float*>(grad), static_cast<float*>(dqkv), stats, L,
        D, H, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mha_qkv_bwd_dkdv_f32<HD><<<grid, BR, 0, stream>>>(
        static_cast<const float*>(qkv), mask,
        static_cast<const float*>(grad), static_cast<float*>(dqkv), stats, L,
        D, H, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// qkv [B, L, 3D] and grad [B, L, D] (dtype 0: float32, 1: bfloat16; both
// 16-byte aligned), mask [L, L] float32, dqkv [B, L, 3D] of qkv's dtype,
// stats float32 scratch of 3 * B * H * L; all contiguous on the current
// device, head dim D / H in {16, 32, 64}. Returns the launches'
// cudaError_t (0 on success); does not synchronise.
extern "C" int mha_qkv_bwd(const void* qkv, const void* mask,
                           const void* grad, void* dqkv, void* stats, int B,
                           int L, int D, int H, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535 || D % H != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / H) {
    case 16: return launch<16>(qkv, m, grad, dqkv, st, B, L, D, H, dtype, s);
    case 32: return launch<32>(qkv, m, grad, dqkv, st, B, L, D, H, dtype, s);
    case 64: return launch<64>(qkv, m, grad, dqkv, st, B, L, D, H, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
