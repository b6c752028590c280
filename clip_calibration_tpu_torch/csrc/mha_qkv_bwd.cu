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
// - fp32 (fp32 FMAs on the CUDA cores, no TF32): bound by operations at
//   the vision shape, 159 us (10 B H L^2 d at 67 TFLOP/s). The same
//   register micro-tiles as K1's fp32 instance (attention_tile.cuh): each
//   thread holds 4 rows x 4 columns of the score-shaped products (q k^T,
//   g v^T; in the dk/dv kernel k q^T, v g^T) and 4 rows x d / 16 columns
//   of dq, or of dk and dv (32 accumulators at d 64, none spilled); P and
//   ds reach the products that contract over keys or queries (ds k, P^T
//   g, ds^T q) through shared tiles written and read by one half warp.
//   The streamed tiles (K and V, or q and g) come through a two-stage
//   cp.async ring; the mask and the statistics are read straight from L2.
//   The dq kernel walks pass 1 from the last key tile to the first and
//   begins pass 2 with tile 0's scores still in registers, so at L <= 64
//   (the text towers) no tile is computed twice. Blocks cover 16, 32 or
//   64 rows: the most whose padding past L stays within 10% of L, halved
//   while the grid would leave SMs idle.
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

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MROWS = 16 * MMA_WARPS;  // rows a block owns
constexpr int MTILE = 64;              // rows of the streamed tile
constexpr int PAD = 8;                 // bf16 per smem row: no bank conflicts

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
// fp32: register micro-tiles on the CUDA cores (attention_tile.cuh)
// ---------------------------------------------------------------------------

constexpr int F32_STAGES = 2;  // the ring: tile j + 1 copies while j runs

template <int HD, int ROWS>
struct BwdF32 {
  static constexpr int THREADS = ROWS * 4;  // 16 threads per 4 rows
  static constexpr int TN = HD / 16;        // output columns a thread
  static constexpr int KS = HD + 4;         // floats per smem row
  static constexpr int TILE = F32_TILE * KS;  // floats per streamed tile
  static constexpr int OWN = ROWS * KS;       // floats per resident block
  // two resident operands, the ring (two streamed operands per stage) and
  // one (dq) or two (dk/dv) weight tiles; dq 96 KB, dk/dv 104 KB at ROWS
  // 32 and HD 64: two blocks an SM
  static constexpr int SMEM_DQ =
      (2 * OWN + F32_STAGES * 2 * TILE + ROWS * F32_PS) * 4;
  static constexpr int SMEM_DKDV =
      (2 * OWN + F32_STAGES * 2 * TILE + 2 * ROWS * F32_PS) * 4;
};

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[4][HD / 16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) acc[r][n] = 0.f;
}

// dq: a block owns ROWS query rows of one head, q and g resident; K and V
// tiles stream through the ring twice, the ring running across the
// boundary of the passes. Pass 1 (the row statistics) walks the key tiles
// last to first, so it ends on tile 0, whose scores and dp are still in
// registers when the statistics are complete: pass 2 (ds and dq) takes
// tile 0 from them and streams only tiles 1 .. n - 1 again. At L <= 64
// (one tile: the text towers) nothing is streamed or recomputed twice.
template <int HD, int ROWS>
__global__ void __launch_bounds__(ROWS * 4)
    mha_qkv_bwd_dq_f32(const float* __restrict__ qkv,
                       const float* __restrict__ mask,
                       const float* __restrict__ grad,
                       float* __restrict__ dqkv, float* __restrict__ stats,
                       int L, int D, int H, float scale) {
  using F = BwdF32<HD, ROWS>;
  constexpr int TN = F::TN, KS = F::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* gs = qs + F::OWN;
  float* ring = gs + F::OWN;
  float* dss = ring + F32_STAGES * 2 * F::TILE;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row0 = q0 + 4 * ty;
  const bool active = q0 + (tid / 32) * 8 < L;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const int ntiles = (L + F32_TILE - 1) / F32_TILE;
  const int walk = 2 * ntiles - 1;
  // the key tile of step i: n - 1 .. 0 (pass 1), then 1 .. n - 1 (pass 2)
  auto key_tile = [&](int i) {
    return i < ntiles ? ntiles - 1 - i : i - ntiles + 1;
  };

  auto issue = [&](int i) {
    float* kt = ring + (i % F32_STAGES) * 2 * F::TILE;
    const int k0 = key_tile(i) * F32_TILE;
    load_tile_f32<F32_TILE, HD>(kt, base + D + h * HD, stride, k0, L,
                                F::THREADS);
    load_tile_f32<F32_TILE, HD>(kt + F::TILE, base + 2 * D + h * HD, stride,
                                k0, L, F::THREADS);
  };
  load_tile_f32<ROWS, HD>(qs, base + h * HD, stride, q0, L, F::THREADS);
  load_tile_f32<ROWS, HD>(gs, grad + (long long)b * L * D + h * HD, D, q0, L,
                          F::THREADS);
  issue(0);
  cp_async_commit();

  const float* qrow = qs + 4 * ty * KS;
  const float* grow = gs + 4 * ty * KS;
  float* dsrow = dss + 4 * ty * F32_PS;
  float m[4], l[4], dsum[4], inv_l[4], delta[4], dq[4][TN];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -FLT_MAX;
    l[r] = dsum[r] = 0.f;
  }
  zero_acc<HD>(dq);

  for (int i = 0; i < walk; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < walk) issue(i + 1);
    cp_async_commit();
    if (!active) continue;
    const int k0 = key_tile(i) * F32_TILE, nk = min(F32_TILE, L - k0);
    const float* ks = ring + (i % F32_STAGES) * 2 * F::TILE;
    const float* vs = ks + F::TILE;
    float mk[4][4];
    load_mask_f32<false>(mk, mask, L, row0, k0 + tx);

    auto step = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      const int nj = (nk + 15) / 16;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
      mt_dot<HD, FULL>(s, qrow, ks + tx * KS, KS, nj);
      mt_dot<HD, FULL>(dp, grow, vs + tx * KS, KS, nj);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)  // keys past L: s = -inf, P = 0
          s[r][j] = FULL || tx + 16 * j < nk ? s[r][j] * scale + mk[r][j]
                                             : -INFINITY;
      if (i < ntiles) {  // pass 1: online max, sum and rowsum(dp o P)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) tmax = fmaxf(tmax, s[r][j]);
          const float m_new = fmaxf(m[r], half_warp_reduce<false>(tmax));
          const float alpha = expf(m[r] - m_new);
          m[r] = m_new;
          float rsum = 0.f, rdot = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = expf(s[r][j] - m_new);
            rsum += p;
            rdot = fmaf(p, dp[r][j], rdot);
          }
          l[r] = l[r] * alpha + half_warp_reduce<true>(rsum);
          dsum[r] = dsum[r] * alpha + half_warp_reduce<true>(rdot);
        }
        if (i < ntiles - 1) return;
        // tile 0, the last of pass 1: the statistics are complete, and
        // pass 2 begins with this tile's s and dp
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          inv_l[r] = 1.f / l[r];  // l >= 1: the max contributes exp(0)
          delta[r] = dsum[r] * inv_l[r];
        }
        if (tx == 0) {
          const long long bhl = (long long)gridDim.z * H * L;
          float* st = stats + ((long long)b * H + h) * L;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (row0 + r < L) {
              st[row0 + r] = m[r];
              st[bhl + row0 + r] = inv_l[r];
              st[2 * bhl + row0 + r] = delta[r];
            }
        }
      }
      // pass 2: ds = P o (dp - Delta), dq += ds k
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (FULL || j < nj)
            dsrow[r * F32_PS + tx + 16 * j] =
                expf(s[r][j] - m[r]) * inv_l[r] * (dp[r][j] - delta[r]);
      __syncwarp();  // ds's rows come from this half warp alone
      mt_acc<HD, FULL>(dq, dsrow, ks + tx * TN, nj * 16);
      __syncwarp();  // ds is read before the next tile overwrites it
    };
    if (nk == F32_TILE)
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  if (!active) return;
  float* ob = dqkv + (long long)b * L * stride + h * HD + tx * TN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= L) continue;
    float v[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) v[n] = dq[r][n] * scale;
    st_f32<TN>(ob + (row0 + r) * stride, v);
  }
}

// dk/dv: a block owns ROWS key rows of one head, k and v resident; q and g
// tiles stream through the ring. The score tiles are transposed (rows
// keys, columns queries): s^T = k q^T, dp^T = v g^T, then P^T and ds^T
// from the stored row statistics, dv += P^T g and dk += ds^T q.
template <int HD, int ROWS>
__global__ void __launch_bounds__(ROWS * 4)
    mha_qkv_bwd_dkdv_f32(const float* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const float* __restrict__ grad,
                         float* __restrict__ dqkv,
                         const float* __restrict__ stats, int L, int D,
                         int H, float scale) {
  using F = BwdF32<HD, ROWS>;
  constexpr int TN = F::TN, KS = F::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* kso = reinterpret_cast<float*>(smem);
  float* vso = kso + F::OWN;
  float* ring = vso + F::OWN;
  float* pts = ring + F32_STAGES * 2 * F::TILE;
  float* dts = pts + ROWS * F32_PS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int key0 = k0 + 4 * ty;  // this thread's keys: key0 .. key0 + 3
  const bool active = k0 + (tid / 32) * 8 < L;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const float* gb = grad + (long long)b * L * D + h * HD;
  const long long bhl = (long long)gridDim.z * H * L;
  const float* st = stats + ((long long)b * H + h) * L;
  const int ntiles = (L + F32_TILE - 1) / F32_TILE;

  auto issue = [&](int i) {
    float* qt = ring + (i % F32_STAGES) * 2 * F::TILE;
    load_tile_f32<F32_TILE, HD>(qt, base + h * HD, stride, i * F32_TILE, L,
                                F::THREADS);
    load_tile_f32<F32_TILE, HD>(qt + F::TILE, gb, D, i * F32_TILE, L,
                                F::THREADS);
  };
  load_tile_f32<ROWS, HD>(kso, base + D + h * HD, stride, k0, L, F::THREADS);
  load_tile_f32<ROWS, HD>(vso, base + 2 * D + h * HD, stride, k0, L,
                          F::THREADS);
  issue(0);
  cp_async_commit();

  const float* krow = kso + 4 * ty * KS;
  const float* vrow = vso + 4 * ty * KS;
  float* prow = pts + 4 * ty * F32_PS;
  float* dsrow = dts + 4 * ty * F32_PS;
  float dk[4][TN], dv[4][TN];
  zero_acc<HD>(dk);
  zero_acc<HD>(dv);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < ntiles) issue(i + 1);
    cp_async_commit();
    if (!active) continue;
    const int q0 = i * F32_TILE, nq = min(F32_TILE, L - q0);
    const float* qs = ring + (i % F32_STAGES) * 2 * F::TILE;
    const float* gs = qs + F::TILE;
    float mk[4][4], sm[4], sil[4], sdl[4];
    load_mask_f32<true>(mk, mask, L, key0, q0 + tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the statistics of query q0 + tx + 16 j
      const int q = q0 + tx + 16 * j;
      sm[j] = q < L ? __ldg(st + q) : 0.f;
      sil[j] = q < L ? __ldg(st + bhl + q) : 0.f;
      sdl[j] = q < L ? __ldg(st + 2 * bhl + q) : 0.f;
    }

    auto step = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      const int nj = (nq + 15) / 16;
      float p[4][4], ds[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[r][j] = ds[r][j] = 0.f;
      mt_dot<HD, FULL>(p, krow, qs + tx * KS, KS, nj);   // s^T
      mt_dot<HD, FULL>(ds, vrow, gs + tx * KS, KS, nj);  // dp^T
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!FULL && j >= nj) continue;
          // queries past L contribute nothing
          const float pv = FULL || tx + 16 * j < nq
                               ? expf(p[r][j] * scale + mk[r][j] - sm[j]) *
                                     sil[j]
                               : 0.f;
          prow[r * F32_PS + tx + 16 * j] = pv;
          dsrow[r * F32_PS + tx + 16 * j] = pv * (ds[r][j] - sdl[j]);
        }
      __syncwarp();  // P^T's and ds^T's rows come from this half warp
      mt_acc<HD, FULL>(dv, prow, gs + tx * TN, nj * 16);   // P^T g
      mt_acc<HD, FULL>(dk, dsrow, qs + tx * TN, nj * 16);  // ds^T q
      __syncwarp();  // both are read before the next tile overwrites them
    };
    if (nq == F32_TILE)
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  if (!active) return;
  float* kout = dqkv + (long long)b * L * stride + D + h * HD + tx * TN;
  float* vout = kout + D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (key0 + r >= L) continue;
    float vk[TN], vv[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      vk[n] = dk[r][n] * scale;
      vv[n] = dv[r][n];
    }
    st_f32<TN>(kout + (key0 + r) * stride, vk);
    st_f32<TN>(vout + (key0 + r) * stride, vv);
  }
}

template <int HD, int ROWS>
cudaError_t launch_f32(const float* qkv, const float* mask, const float* grad,
                       float* dqkv, float* stats, int B, int L, int D, int H,
                       float scale, cudaStream_t stream) {
  using F = BwdF32<HD, ROWS>;
  static size_t allowed_dq = 0, allowed_dkdv = 0;
  auto dq = mha_qkv_bwd_dq_f32<HD, ROWS>;
  auto dkdv = mha_qkv_bwd_dkdv_f32<HD, ROWS>;
  cudaError_t err = allow_smem(dq, F::SMEM_DQ, allowed_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv, F::SMEM_DKDV, allowed_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + ROWS - 1) / ROWS, H, B);
  dq<<<grid, F::THREADS, F::SMEM_DQ, stream>>>(qkv, mask, grad, dqkv, stats,
                                                L, D, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<grid, F::THREADS, F::SMEM_DKDV, stream>>>(qkv, mask, grad, dqkv,
                                                    stats, L, D, H, scale);
  return cudaGetLastError();
}

// blocks that fill the card: 132 SMs
constexpr int SMS = 132;
// the padded rows a block size may add, in percent of L: at 64 rows the
// kernels' registers and shared memory allow one block of 8 warps an SM,
// as at 32, so padding only costs (tools/kernel_variants.py `rows_64`)
constexpr int F32_WASTE_PCT = 10;

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
    return cudaGetLastError();
  }
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(grad);
  float* dq = static_cast<float*>(dqkv);
  switch (f32_fill_rows(f32_pad_rows(L, F32_WASTE_PCT), L, (long long)H * B,
                        SMS)) {
    case 64:
      return launch_f32<HD, 64>(q, mask, g, dq, stats, B, L, D, H, scale,
                                stream);
    case 32:
      return launch_f32<HD, 32>(q, mask, g, dq, stats, B, L, D, H, scale,
                                stream);
    default:
      return launch_f32<HD, 16>(q, mask, g, dq, stats, B, L, D, H, scale,
                                stream);
  }
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
