// Fused multi-head attention forward over a packed QKV tensor (K1).
//
// Replaces the TPU kernel clip_calibration_tpu/ops/pallas_attention.py::
// _mha_qkv_kernel (reached through _fwd_impl's pl.pallas_call). Same
// function: per batch row b and head h,
//     out[b, :, h*d:(h+1)*d] = softmax((q_h / sqrt(d)) k_h^T + mask) v_h
// with q_h, k_h, v_h the column slices [h*d, D+h*d, 2D+h*d] + [0, d) of
// qkv[b] ([L, 3D], row stride 3D) and an additive fp32 [L, L] mask shared
// by every row and head. Scores, softmax and the P.V sums are fp32.
//
// What bounds it on an H100 SXM: at the CLIP shapes the bf16 case is
// memory-bound. ViT-B/16 vision, qkv [32, 208, 2304] bf16: 41.1 MB moved
// (qkv and mask in, out) is 12.3 us at 3.35 TB/s, against 4.25 GFLOP =
// 4.3 us at the 989 TFLOP/s bf16 tensor-core peak. In fp32 (no tensor
// cores) the same work is 63 us at the 67 TFLOP/s fp32 peak: bound by
// operations. What the design does about it: every qkv element is read
// from device memory once per block that needs it and the [L, L] scores
// never leave the SM (no [B, H, L, L] tensor, no head transposes: q/k/v
// are read in place from the packed layout and the output is written
// straight into its head's columns).
//
// Unlike the TPU kernel, which holds one whole [L, 3D] row in VMEM and
// loops over heads, a block here owns one tile of queries of one head
// (grid: query tiles x heads x batch) and streams the keys in tiles
// through shared memory with an online softmax (fp32 running max and
// running sum per row, fp32 accumulator in registers). No [L, L] block is
// ever resident, so any L fits: at ViT-L/14@336px in fp32, K and V of one
// head alone would exceed the 227 KB of shared memory.
//
// Two kernels, by input type; both simple (synchronous tile loads, no
// TMA/wgmma yet):
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate). 4 warps x 16 query rows; S = Q K^T and O += P V per
//   64-key tile, with K, V and the tile's mask staged in shared memory by
//   coalesced loads. The S accumulator fragment is re-packed in registers
//   as the A operand of P V (P rounded to bf16, as the JAX kernel rounds
//   P to v's dtype); V's B fragments come from ldmatrix.trans.
// - fp32: one thread per query row, fp32 FMAs from shared-memory tiles
//   (broadcast reads), so fp32 runs stay full fp32 (no TF32).
//
// Masks use finfo(float32).min, never -inf, as the towers build them. The
// running max starts at -FLT_MAX, so a tile whose keys are all masked for
// a row contributes exp(0) terms exactly as a plain softmax over such a
// row would, and the first finite key rescales them by exp(-FLT_MAX - m)
// = 0. Keys past L (the ragged edge of the last tile) get no weight;
// query rows past L are computed and never stored.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MBQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MBK = 64;              // keys per shared-memory tile
constexpr int PAD = 8;               // bf16 per smem row: no bank conflicts

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

// Four transposed 8x8 bf16 matrices from shared memory: lanes 8i..8i+7
// give the row addresses of matrix i, and each thread receives, per
// matrix, the pair (rows 2t, 2t+1; column g) — the B fragment of a
// row-major [k][n] tile.
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

// Fragment layouts (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4.
// A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..). B 16x8: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).
// C 16x8: c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    mha_qkv_fwd_bf16(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int L, int D,
                     float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[MBK][HD + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[MBK][HD + PAD];
  // mask tile; a row stride of 8 (mod 32) words keeps the float2 reads
  // below free of bank conflicts
  __shared__ __align__(16) float ms[MBQ][MBK + 8];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_blk = blockIdx.x * MBQ;
  const int r0 = q_blk + warp * 16 + g;  // this thread's rows: r0 and r1
  const int r1 = r0 + 8;
  const bool active = q_blk + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const __nv_bfloat16* qb = base + h * HD;
  const __nv_bfloat16* kb = base + D + h * HD;
  const __nv_bfloat16* vb = base + 2 * D + h * HD;

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < L ? ld_pair(qb + r0 * stride + c) : 0u;
    qa[kk][1] = r1 < L ? ld_pair(qb + r1 * stride + c) : 0u;
    qa[kk][2] = r0 < L ? ld_pair(qb + r0 * stride + c + 8) : 0u;
    qa[kk][3] = r1 < L ? ld_pair(qb + r1 * stride + c + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < L; k0 += MBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < MBK * HD / 8; i += MMA_WARPS * 32) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < L) {
        kv = *reinterpret_cast<const uint4*>(kb + key * stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * stride + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    for (int i = tid; i < MBQ * MBK; i += MMA_WARPS * 32) {
      const int r = i / MBK, c = i % MBK, row = q_blk + r, key = k0 + c;
      ms[r][c] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[MBK / 8][4];
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(s[n], qa[kk], ld_pair(&ks[n * 8 + g][kk * 16 + 2 * t]),
                 ld_pair(&ks[n * 8 + g][kk * 16 + 2 * t + 8]));
    }

    float tmax[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 m0 = *reinterpret_cast<const float2*>(&ms[warp * 16 + g][c]);
      const float2 m1 =
          *reinterpret_cast<const float2*>(&ms[warp * 16 + g + 8][c]);
      const float mk[4] = {m0.x, m0.y, m1.x, m1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // keys past L get no weight
        const float v =
            k0 + c + (e & 1) < L ? s[n][e] * scale + mk[e] : -INFINITY;
        s[n][e] = v;
        tmax[e / 2] = fmaxf(tmax[e / 2], v);
      }
    }
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
    for (int n = 0; n < MBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);
        rsum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < MBK / 16; ++kc) {  // 16 keys per P.V step
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

  if (!active) return;
  // l >= 1: the running max itself contributes exp(0)
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  __nv_bfloat16* ob = out + (long long)b * L * D + h * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + n * 8) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + n * 8) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block, one thread each
constexpr int BK = 32;  // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(BQ)
    mha_qkv_fwd_f32(const float* __restrict__ qkv,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int L, int D, float scale) {
  __shared__ float qs[BQ][HD + 1];  // Q tile in, output tile out (+1: no
                                    // bank conflicts on per-row access)
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  __shared__ float ms[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const float* qb = base + h * HD;
  const float* kb = base + D + h * HD;
  const float* vb = base + 2 * D + h * HD;

  for (int i = tid; i < BQ * HD; i += BQ) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    qs[r][c] = row < L ? qb[row * stride + c] * scale : 0.f;
  }
  __syncthreads();

  float q[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    q[c] = qs[tid][c];
    acc[c] = 0.f;
  }
  float m = -FLT_MAX, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * HD; i += BQ) {
      const int r = i / HD, c = i % HD, key = k0 + r;
      const bool ok = key < L;
      ks[r][c] = ok ? kb[key * stride + c] : 0.f;
      vs[r][c] = ok ? vb[key * stride + c] : 0.f;
    }
    for (int i = tid; i < BQ * BK; i += BQ) {
      const int r = i / BK, c = i % BK, row = q0 + r, key = k0 + c;
      ms[r][c] = (row < L && key < L) ? mask[(long long)row * L + key] : 0.f;
    }
    __syncthreads();

    const int nk = min(BK, L - k0);
    float s[BK];
    float tile_max = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot = fmaf(q[c], ks[j][c], dot);
      s[j] = dot + ms[tid][j];
      if (j < nk) tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = j < nk ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    m = m_new;
  }

  // l >= 1: the running max itself contributes exp(0)
  const float inv = 1.f / l;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < HD; ++c) qs[tid][c] = acc[c] * inv;
  __syncthreads();
  float* ob = out + (long long)b * L * D + h * HD;
  for (int i = tid; i < BQ * HD; i += BQ) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    if (row < L) ob[(long long)row * D + c] = qs[r][c];
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B,
                   int L, int D, int H, int dtype, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (dtype == 1) {
    const dim3 grid((L + MBQ - 1) / MBQ, H, B);
    mha_qkv_fwd_bf16<HD><<<grid, MMA_WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), mask,
        static_cast<__nv_bfloat16*>(out), L, D, scale);
  } else {
    const dim3 grid((L + BQ - 1) / BQ, H, B);
    mha_qkv_fwd_f32<HD><<<grid, BQ, 0, stream>>>(
        static_cast<const float*>(qkv), mask, static_cast<float*>(out), L,
        D, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// qkv [B, L, 3D] (dtype 0: float32, 1: bfloat16; 16-byte aligned),
// mask [L, L] float32, out [B, L, D] of qkv's dtype; all contiguous on the
// current device, head dim D / H in {16, 32, 64}. Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int mha_qkv_fwd(const void* qkv, const void* mask, void* out,
                           int B, int L, int D, int H, int dtype,
                           void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535 || D % H != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / H) {
    case 16: return launch<16>(qkv, m, out, B, L, D, H, dtype, s);
    case 32: return launch<32>(qkv, m, out, B, L, D, H, dtype, s);
    case 64: return launch<64>(qkv, m, out, B, L, D, H, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
