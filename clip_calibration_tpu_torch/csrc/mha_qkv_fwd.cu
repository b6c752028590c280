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
// Bound on an H100 SXM at the main shape (ViT-B/16 vision, qkv
// [32, 208, 2304] bf16, 12 heads, d 64): bytes. qkv 30.7 MB + mask 0.17 MB
// in, out 10.2 MB = 41.1 MB, 12.3 us at 3.35 TB/s, against 4 B H L^2 d =
// 4.25 GFLOP, 4.3 us at the 989 TFLOP/s bf16 peak. In fp32 (no tensor
// cores) the same work is 63 us at the 67 TFLOP/s fp32 peak: operations.
//
// DRAM and L2 per call at that shape: every qkv element comes from DRAM
// once (41.1 MB in all; the blocks that share a head run side by side).
// From L2 the bf16 kernel reads each head's K and V once per query chunk
// of 64 rows (4 chunks at L 208: 81.7 MB), q once (10.2 MB) and each mask
// row once per block, i.e. once per group of HG heads (HG 2 at batch 32:
// 6 x 0.17 MB per batch row, 33.2 MB): about 125 MB. The design before
// this one read a 64 x 64 fp32 mask tile per block and key tile (101 MB)
// besides K and V, about 193 MB.
//
// What the design does about it, bf16 (mma.sync m16n8k16, bf16 in, fp32
// accumulate, online softmax):
// - A block is NW warps (1, 2 or 4) x 16 query rows of one batch row and
//   walks over a group of HG heads (grid: query chunks x head groups x
//   batch). The launcher picks NW and HG so that the grid fills the 132
//   SMs: NW 1 at batch 1 (156 blocks at L 208), NW 4 and HG up to 4 at
//   batch 32-64. No warp is idle because L is short (NW 2 at L 32).
// - The chunk's mask rows [16 NW, L] are staged in shared memory once and
//   serve every head of the group (where they fit, 60 KB; else, at long L,
//   the mask tile streams with the keys and HG is 1).
// - K and V arrive in 64-key tiles through a two-stage cp.async ring that
//   runs across the head boundary, with one barrier a tile: the copy of
//   tile j + 1 (and, at a head's first tile, its q rows) is in flight
//   while the warps compute tile j. No synchronous load is left in the
//   loop. K's B fragments come from ldmatrix.
// - A ragged last tile costs what it holds, to 16 keys: 16-key chunks past
//   L are skipped (the 208th key ends a 16-key tile; the old kernel ran 48
//   padding keys at full cost).
// - The S accumulator fragment is re-packed in registers as the A operand
//   of P V (P rounded to bf16 unnormalised; the JAX kernel rounds the
//   normalised P to v's dtype); V's B fragments come from ldmatrix.trans.
//   The [L, L] scores never leave the SM and the output is written once,
//   straight into its head's columns. exp is __expf (ex2.approx of
//   x log2 e), whose error is far below bf16's.
// - Head dim 104 (OpenCLIP ViT-bigG/14's vision tower, 16 heads of 104):
//   104 = 6 x 16 + 8, so QK^T takes six m16n8k16 steps over d and one
//   m16n8k8 step over its last 8 columns (B from ldmatrix.x2), and P V has
//   13 output n-tiles, the last one alone (ldmatrix.x2.trans): no padded
//   column is loaded or multiplied. Shared-memory rows are 120 bf16 (15
//   16-byte units: an odd count keeps ldmatrix's 8 rows on distinct
//   banks; 112 would pair them). A row is 13 16-byte cp.async copies. At
//   L 257 (streamed mask, one head a block, one q buffer) a 4-warp block
//   holds 111 KB, so two share an SM; o[13][4] and q's 26 fragment
//   registers fit without spilling (the build line's ptxas counts).
//
// fp32 (the golden-parity precision; fp32 FMAs on the CUDA cores, no tensor
// cores, so no TF32): bound by operations, 63.5 us at the vision shape
// (4 B H L^2 d = 4.25 GFLOP at 67 TFLOP/s) against 24.5 us of bytes.
// What the design does about it (attention_tile.cuh, fp32 micro-tiles):
// - Register micro-tiles, as a SIMT GEMM: a block of 16 ROWS / 4 threads
//   owns ROWS (16, 32 or 64) query rows of one head; each thread holds 4
//   rows x 4 keys of S and 4 rows x d / 16 columns of O, so one step of 4
//   along d is 8 float4 shared-memory loads for 64 FMAs. q, K and V stay
//   row-major in shared memory with rows padded by 4 floats, so the
//   float4 reads of 16 rows fall on distinct banks.
// - Online softmax across the 16 threads of a half warp that share rows
//   (__shfl_xor_sync); P goes through a [ROWS, 64] shared tile into the
//   P V micro-tiles, written and read by the same half warp (__syncwarp).
// - K and V arrive in 64-key tiles through a two-stage cp.async ring (16-
//   byte copies), one barrier a tile. The mask is read straight from L2
//   (16 values a thread a tile, issued before q k^T): against the tile's
//   128 d FMAs a thread, staging it would save little and cost the
//   shared memory of a third ring operand.
// - The grid fills 132 SMs: ROWS is 64, halved while chunks x H x B is
//   under the SM count (16 at batch 1: 156 blocks). Two blocks of 8 warps
//   share an SM; at L 208 the last chunk pads 48 rows, whose warps skip
//   the products and only keep the ring going. A ragged last key tile
//   skips its 16-key groups past L.
// - expf, as the plain version's softmax; error well inside the 1e-4
//   tolerance (measured: about 1e-6 absolute at the launched shapes).
//
// Masks use finfo(float32).min, never -inf, as the towers build them. The
// running max starts at -FLT_MAX, so a tile whose keys are all masked for
// a row contributes exp(0) terms exactly as a plain softmax over such a
// row would, and the first finite key rescales them by exp(-FLT_MAX - m)
// = 0. Keys past L get no weight; query rows past L are zeros in shared
// memory, computed and never stored.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MBK = 64;  // keys per ring tile
// ring depth: the copy of tile j + 1 overlaps the products on tile j (a
// third stage measured no faster on the H100 and costs the occupancy of
// the staged mask); the two q buffers below rely on it
constexpr int STAGES = 2;
constexpr int MT_STRIDE = MBK + 8;  // floats per row of a streamed mask tile
// the largest staged mask (bytes): two blocks of 4 warps still fit an SM
constexpr int MASK_SMEM_MAX = 60 * 1024;

template <int HD, int NW>
struct Fwd {
  static constexpr int THREADS = 32 * NW;
  static constexpr int ROWS = 16 * NW;       // query rows per block
  static constexpr int KS = smem_row(HD);    // bf16 per K/V/q smem row
  static constexpr int KV = MBK * KS;        // bf16 per K (or V) tile
  // shared memory: the ring (K and V per stage), q (two buffers where a
  // block walks two heads or more, else one), the mask
  static constexpr int RING_BYTES = STAGES * 2 * KV * 2;
  __host__ __device__ static constexpr int q_bytes(int hg) {
    return (hg > 1 ? 2 : 1) * ROWS * KS * 2;
  }
  static size_t smem(bool whole, int mstride, int hg) {
    return RING_BYTES + q_bytes(hg) +
           (whole ? (size_t)ROWS * mstride * 4
                  : (size_t)STAGES * ROWS * MT_STRIDE * 4);
  }
};

// Fragment layouts: attention_tile.cuh.
template <int HD, int NW, bool WHOLE>
__global__ void __launch_bounds__(NW * 32)
    mha_qkv_fwd_bf16(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int L, int D, int HG,
                     int mstride, float scale) {
  using F = Fwd<HD, NW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ring + STAGES * 2 * F::KV;
  float* ms =
      reinterpret_cast<float*>(smem + F::RING_BYTES + F::q_bytes(HG));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * F::ROWS, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const bool active = q0 + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const int ntiles = (L + MBK - 1) / MBK;
  const int total = HG * ntiles;

  // tile i of the walk: head h0 + i / ntiles, keys (i % ntiles) * MBK ..
  auto issue = [&](int i) {
    const int hh = i / ntiles, k0 = (i % ntiles) * MBK, h = h0 + hh;
    __nv_bfloat16* kt = ring + (i % STAGES) * 2 * F::KV;
    load_tile<MBK, HD>(kt, base + D + h * HD, stride, k0, L, F::THREADS);
    load_tile<MBK, HD>(kt + F::KV, base + 2 * D + h * HD, stride, k0, L,
                       F::THREADS);
    if (k0 == 0)  // a head's first tile brings its q rows
      load_tile<F::ROWS, HD>(qs + (hh & 1) * F::ROWS * F::KS, base + h * HD,
                             stride, q0, L, F::THREADS);
    if constexpr (!WHOLE)
      load_mask(ms + (i % STAGES) * F::ROWS * MT_STRIDE, MT_STRIDE, mask,
                L, q0, F::ROWS, k0, MBK, F::THREADS);
  };

  if constexpr (WHOLE)
    load_mask(ms, mstride, mask, L, q0, F::ROWS, 0, (L + 15) / 16 * 16,
              F::THREADS);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }

  // a head dim 8 past a multiple of 16 (104) takes its last 8 columns in
  // one m16n8k8 step (TAIL): no padded columns are computed
  constexpr bool TAIL = HD % 16 != 0;
  constexpr int NT = HD / 8;  // n-tiles of the output (13 at 104)
  uint32_t qa[HD / 16][4];
  uint32_t qt[2];
  float o[NT][4];
  float m[2], l[2];

  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and tile i - 1 is consumed
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);  // tile i - 1's stage
    cp_async_commit();
    const int hh = i / ntiles, k0 = (i % ntiles) * MBK, h = h0 + hh;
    const int nk = min(MBK, L - k0);
    const __nv_bfloat16* ks = ring + (i % STAGES) * 2 * F::KV;
    const __nv_bfloat16* vs = ks + F::KV;
    const float* mrow;
    int mld;
    if constexpr (WHOLE) {
      mrow = ms + (warp * 16 + g) * mstride + k0;
      mld = mstride;
    } else {
      mrow = ms + (i % STAGES) * F::ROWS * MT_STRIDE +
             (warp * 16 + g) * MT_STRIDE;
      mld = MT_STRIDE;
    }

    if (active) {
      if (k0 == 0) {  // a new head: its q fragments, fresh statistics
        const __nv_bfloat16* qrow =
            qs + (hh & 1) * F::ROWS * F::KS + (warp * 16 + g) * F::KS;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk * 16 + 2 * t;
          qa[kk][0] = ld_pair(qrow + c);
          qa[kk][1] = ld_pair(qrow + 8 * F::KS + c);
          qa[kk][2] = ld_pair(qrow + c + 8);
          qa[kk][3] = ld_pair(qrow + 8 * F::KS + c + 8);
        }
        if constexpr (TAIL) {
          qt[0] = ld_pair(qrow + HD - 8 + 2 * t);
          qt[1] = ld_pair(qrow + 8 * F::KS + HD - 8 + 2 * t);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
          o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
        m[0] = m[1] = -FLT_MAX;
        l[0] = l[1] = 0.f;
      }

      // one step over the tile; a full tile (every tile but a ragged last
      // one) compiles without the 16-key guards, so the scheduler can
      // interleave its mma chains and exps across the whole tile
      auto step = [&](auto full) {
        constexpr bool FULL = decltype(full)::value;
        // scores of 16-key chunks that hold a key < L; the rest stay -inf
        float s[MBK / 8][4];
#pragma unroll
        for (int np = 0; np < MBK / 16; ++np) {  // n-tiles 2 np, 2 np + 1
          float acc[2][4] = {};
          if (FULL || np * 16 < nk) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              uint32_t b0, b1, b2, b3;
              ldmatrix_x4(b0, b1, b2, b3,
                          ks + (np * 16 + (lane / 16) * 8 + lane % 8) * F::KS +
                              kk * 16 + ((lane / 8) & 1) * 8);
              mma_bf16(acc[0], qa[kk], b0, b1);
              mma_bf16(acc[1], qa[kk], b2, b3);
            }
            if constexpr (TAIL) {  // d columns HD - 8 .. HD - 1
              uint32_t b0, b1;
              ldmatrix_x2(b0, b1,
                          ks + (np * 16 + ((lane / 8) & 1) * 8 + lane % 8) *
                                   F::KS + HD - 8);
              mma_bf16_k8(acc[0], qt, b0);
              mma_bf16_k8(acc[1], qt, b1);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 2 * np + half;
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = -INFINITY;
            if (!FULL && np * 16 >= nk) continue;
            const int c = n * 8 + 2 * t;
            const float2 m0 = *reinterpret_cast<const float2*>(mrow + c);
            const float2 m1 =
                *reinterpret_cast<const float2*>(mrow + 8 * mld + c);
            const float mk[4] = {m0.x, m0.y, m1.x, m1.y};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // keys past L get no weight
              const float v =
                  FULL || c + (e & 1) < nk
                      ? acc[half][e] * scale + mk[e]
                      : -INFINITY;
              s[n][e] = v;
            }
          }
        }
        float tmax[2] = {row_reduce<false>(s, 0), row_reduce<false>(s, 1)};
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the 4 threads of a group share a row
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float m_new = fmaxf(m[r], tmax[r]);
          alpha[r] = __expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < MBK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = !FULL && (n / 2) * 16 >= nk
                          ? 0.f
                          : __expf(s[n][e] - m[e / 2]);
        }
        float rsum[2] = {row_reduce<true>(s, 0), row_reduce<true>(s, 1)};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
          l[r] = l[r] * alpha[r] + rsum[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
#pragma unroll
        for (int kc = 0; kc < MBK / 16; ++kc) {  // 16 keys per P.V step
          if (!FULL && kc * 16 >= nk) continue;
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kc][0], s[2 * kc][1]),
              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int n = 0; n + 1 < NT; n += 2) {
            uint32_t vb0, vb1, vb2, vb3;  // B fragments of d-tiles n, n+1
            ldmatrix_x4_trans(
                vb0, vb1, vb2, vb3,
                vs + (kc * 16 + lane % 16) * F::KS + n * 8 + (lane / 16) * 8);
            mma_bf16(o[n], pa, vb0, vb1);
            mma_bf16(o[n + 1], pa, vb2, vb3);
          }
          if constexpr (NT % 2) {  // the last d-tile alone
            uint32_t vb0, vb1;
            ldmatrix_x2_trans(vb0, vb1,
                              vs + (kc * 16 + lane % 16) * F::KS + HD - 8);
            mma_bf16(o[NT - 1], pa, vb0, vb1);
          }
        }
      };
      if (nk == MBK)
        step(std::true_type{});
      else
        step(std::false_type{});

      if (k0 + MBK >= L) {  // the head's last tile: normalise and store
        // l >= 1: the running max itself contributes exp(0)
        const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
        const int r1 = r0 + 8;
        __nv_bfloat16* ob = out + (long long)b * L * D + h * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (r0 < L)
            *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + n * 8) =
                pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
          if (r1 < L)
            *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + n * 8) =
                pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: register micro-tiles on the CUDA cores (attention_tile.cuh)
// ---------------------------------------------------------------------------

template <int HD, int ROWS>
struct FwdF32 {
  static constexpr int THREADS = ROWS * 4;  // 16 threads per 4 rows
  static constexpr int TN = HD / 16;        // output columns a thread
  static constexpr int KS = HD + 4;         // floats per K/V/q smem row
  static constexpr int KV = F32_TILE * KS;  // floats per K (or V) tile
  // the ring (K and V per stage), q, and the P tile
  static constexpr int SMEM =
      (STAGES * 2 * KV + ROWS * KS + ROWS * F32_PS) * 4;
};

// two blocks an SM at every ROWS (shared memory: at most 104 KB a block)
template <int HD, int ROWS>
__global__ void __launch_bounds__(ROWS * 4, 2)
    mha_qkv_fwd_f32(const float* __restrict__ qkv,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int L, int D, float scale) {
  using F = FwdF32<HD, ROWS>;
  constexpr int TN = F::TN, KS = F::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = ring + STAGES * 2 * F::KV;
  float* ps = qs + ROWS * KS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row0 = q0 + 4 * ty;  // this thread's rows: row0 .. row0 + 3
  // a warp's 8 rows; a warp wholly past L only keeps the ring going
  const bool active = q0 + (tid / 32) * 8 < L;
  const long long stride = 3LL * D;
  const float* base = qkv + (long long)b * L * stride;
  const int ntiles = (L + F32_TILE - 1) / F32_TILE;

  auto issue = [&](int i) {
    float* kt = ring + (i % STAGES) * 2 * F::KV;
    load_tile_f32<F32_TILE, HD>(kt, base + D + h * HD, stride,
                                i * F32_TILE, L, F::THREADS);
    load_tile_f32<F32_TILE, HD>(kt + F::KV, base + 2 * D + h * HD, stride,
                                i * F32_TILE, L, F::THREADS);
  };
  load_tile_f32<ROWS, HD>(qs, base + h * HD, stride, q0, L, F::THREADS);
  issue(0);
  cp_async_commit();

  float o[4][TN], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < TN; ++n) o[i][n] = 0.f;
    m[i] = -FLT_MAX;
    l[i] = 0.f;
  }
  const float* qrow = qs + 4 * ty * KS;
  float* prow = ps + 4 * ty * F32_PS;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();  // this thread's copies of tile i landed
    __syncthreads();     // everyone's; and tile i - 1 is consumed
    if (i + 1 < ntiles) issue(i + 1);  // into tile i - 1's stage
    cp_async_commit();
    if (!active) continue;
    const int k0 = i * F32_TILE, nk = min(F32_TILE, L - k0);
    const float* ks = ring + (i % STAGES) * 2 * F::KV;
    const float* vs = ks + F::KV;
    float mk[4][4];
    load_mask_f32<false>(mk, mask, L, row0, k0 + tx);

    // a full tile compiles without the 16-key guards; the ragged last
    // one skips the 16-key groups past L
    auto step = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      const int nj = (nk + 15) / 16;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      mt_dot<HD, FULL>(s, qrow, ks + tx * KS, KS, nj);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // keys past L get no weight
          s[r][j] = FULL || tx + 16 * j < nk ? s[r][j] * scale + mk[r][j]
                                             : -INFINITY;
          tmax = fmaxf(tmax, s[r][j]);
        }
        // m stays finite (>= -FLT_MAX): no -inf - -inf
        const float m_new = fmaxf(m[r], half_warp_reduce<false>(tmax));
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = expf(s[r][j] - m_new);
          rsum += s[r][j];
        }
        l[r] = l[r] * alpha + half_warp_reduce<true>(rsum);
#pragma unroll
        for (int n = 0; n < TN; ++n) o[r][n] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (FULL || j < nj) prow[r * F32_PS + tx + 16 * j] = s[r][j];
      }
      __syncwarp();  // P's rows come from this half warp alone
      mt_acc<HD, FULL>(o, prow, vs + tx * TN, nj * 16);
      __syncwarp();  // P is read before the next tile overwrites it
    };
    if (nk == F32_TILE)
      step(std::true_type{});
    else
      step(std::false_type{});
  }

  if (!active) return;
  float* ob = out + (long long)b * L * D + h * HD + tx * TN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= L) continue;
    // l >= 1: the running max itself contributes exp(0)
    const float inv = 1.f / l[r];
    float v[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) v[n] = o[r][n] * inv;
    st_f32<TN>(ob + (long long)(row0 + r) * D, v);
  }
}

// blocks that fill the card: 132 SMs; for the head grouping, four blocks
// an SM (two resident at a time, two waves)
constexpr int SMS = 132;
constexpr int FILL_BLOCKS = 4 * SMS;

template <int HD, int NW, bool WHOLE>
cudaError_t launch_bf16_kernel(dim3 grid, size_t smem, const void* qkv,
                               const float* mask, void* out, int L, int D,
                               int hg, int mstride, float scale,
                               cudaStream_t stream) {
  static size_t allowed = 0;
  auto kernel = mha_qkv_fwd_bf16<HD, NW, WHOLE>;
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask,
      static_cast<__nv_bfloat16*>(out), L, D, hg, mstride, scale);
  return cudaGetLastError();
}

template <int HD, int NW>
cudaError_t launch_bf16(const void* qkv, const float* mask, void* out, int B,
                        int L, int D, int H, float scale,
                        cudaStream_t stream) {
  using F = Fwd<HD, NW>;
  const int chunks = (L + F::ROWS - 1) / F::ROWS;
  // staged mask row stride: keys to a multiple of 16, then = 8 (mod 32)
  // words, so the fragment reads' float2 loads are free of bank conflicts
  const int m16 = (L + 15) / 16 * 16;
  const int mstride = m16 + ((8 - m16 % 32) + 32) % 32;
  const bool whole = (long long)F::ROWS * mstride * 4 <= MASK_SMEM_MAX;
  // the most heads a block walks whose grid still fills the card
  int hg = 1;
  if (whole)
    for (int c = H; c > 1; --c)
      if (H % c == 0 && (long long)chunks * (H / c) * B >= FILL_BLOCKS) {
        hg = c;
        break;
      }
  const dim3 grid(chunks, H / hg, B);
  const size_t smem = F::smem(whole, mstride, hg);
  return whole ? launch_bf16_kernel<HD, NW, true>(grid, smem, qkv, mask, out,
                                                  L, D, hg, mstride, scale,
                                                  stream)
               : launch_bf16_kernel<HD, NW, false>(grid, smem, qkv, mask,
                                                   out, L, D, 1, mstride,
                                                   scale, stream);
}

template <int HD, int ROWS>
cudaError_t launch_f32(const void* qkv, const float* mask, void* out, int B,
                       int L, int D, int H, float scale,
                       cudaStream_t stream) {
  using F = FwdF32<HD, ROWS>;
  static size_t allowed = 0;
  auto kernel = mha_qkv_fwd_f32<HD, ROWS>;
  const cudaError_t err = allow_smem(kernel, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + ROWS - 1) / ROWS, H, B);
  kernel<<<grid, F::THREADS, F::SMEM, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), L, D,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_any(const void* qkv, const float* mask, void* out,
                            int B, int L, int D, int H, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  // 4 warps a block, halved while the grid would leave SMs idle or a half
  // would already cover L. At head dim 104 a block of 4 warps with a
  // streamed mask (L 257) holds 111 KB of shared memory: two still share
  // an SM, as at 64
  int nw = 4;
  while (nw > 1 && (long long)((L + 16 * nw - 1) / (16 * nw)) * H * B < SMS)
    nw /= 2;
  while (nw > 1 && 16 * (nw / 2) >= L) nw /= 2;
  switch (nw) {
    case 4:
      return launch_bf16<HD, 4>(qkv, mask, out, B, L, D, H, scale, stream);
    case 2:
      return launch_bf16<HD, 2>(qkv, mask, out, B, L, D, H, scale, stream);
    default:
      return launch_bf16<HD, 1>(qkv, mask, out, B, L, D, H, scale, stream);
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B,
                   int L, int D, int H, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_bf16_any<HD>(qkv, mask, out, B, L, D, H, stream);
  const float scale = 1.f / sqrtf((float)HD);
  // 64 rows whatever their padding: two 8-warp blocks an SM (at 128
  // registers) outrun 32-row blocks at every measured shape, the padded
  // warps idling (tools/kernel_variants.py `rows_pad_10`, PERF.md)
  switch (f32_fill_rows(64, L, (long long)H * B, SMS)) {
    case 64:
      return launch_f32<HD, 64>(qkv, mask, out, B, L, D, H, scale, stream);
    case 32:
      return launch_f32<HD, 32>(qkv, mask, out, B, L, D, H, scale, stream);
    default:
      return launch_f32<HD, 16>(qkv, mask, out, B, L, D, H, scale, stream);
  }
}

}  // namespace

// qkv [B, L, 3D] (dtype 0: float32, 1: bfloat16; 16-byte aligned),
// mask [L, L] float32, out [B, L, D] of qkv's dtype; all contiguous on the
// current device, head dim D / H in {16, 32, 64}, or 104 in bfloat16.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
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
    case 104:
      return dtype == 1 ? launch_bf16_any<104>(qkv, m, out, B, L, D, H, s)
                        : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}
