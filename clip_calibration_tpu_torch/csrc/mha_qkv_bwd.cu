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
// read in place from their packed layouts and dqkv written in place, the
// [L, L] scores are recomputed on the SM and never written, and at most
// three fp32 numbers per (row, head) go through device memory between
// two kernels.
//
// - bf16, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums), by
//   one of two routes the launcher picks by L:
//   (a) L <= 64 (the text towers: CoOp's L 32, L 16): one kernel, one
//       block of 1, 2 or 4 warps per (head, batch row). q, k, v, g of each head (64 x 64 bf16 each at most) and
//       the [L, L] mask come into shared memory by 16-byte cp.async; the
//       fragments come from ldmatrix. Warp w owns query rows 16 w ..: S = q k^T with every key
//       present, so a whole-row softmax (no online rescaling; the TPU
//       kernel too keeps whole rows in VMEM), dP = g v^T, Delta =
//       rowsum(dP o P), ds, and dq = scale bf16(ds) k from registers. P
//       and ds go to shared memory in bf16 (where the JAX kernel casts
//       them), and the same warp then owns key rows 16 w .. for dv =
//       bf16(P)^T g and dk = scale bf16(ds)^T q, reading them back with
//       ldmatrix.trans: no statistics scratch, no second launch, no
//       product computed twice.
//   (b) L > 64 (the vision towers, ViT-L; any L fits, as no block holds
//       an [L, L] tile): two kernels, blocks of 4 warps x 16 rows, or 2
//       where 4 would leave some of the 132 SMs idle. Each stages
//       its own rows once (q and g; k and v) and streams the other side in
//       64-row tiles with their mask tile (and, for dk/dv, the rows'
//       statistics) through a two-stage cp.async ring, one barrier a tile,
//       as the bf16 K1 does; full tiles take a step without the 16-row
//       guards, a ragged last tile skips its 16-row chunks past L.
//       1. dq: pass 1 walks the key tiles from the last to the first and
//          keeps, online, each row's softmax max m, sum l and Delta
//          (rescaled with the running max as l is), stored as (m, 1/l,
//          Delta) to a small fp32 scratch [3, B, H, L]; pass 2 starts with
//          tile 0, whose scores are still in registers, and accumulates
//          dq: 2 n - 1 tile visits for n tiles.
//       2. dk/dv: P^T and ds^T recomputed from the stored statistics; dk
//          and dv accumulate in registers.
//   The score-shaped products take their B fragments from row-major
//   shared tiles by ldmatrix; the products that contract over keys or
//   queries re-pack the fp32 accumulator fragment as a bf16 A operand
//   (rounding P and ds to bf16 exactly where the JAX kernel casts them)
//   and load B with ldmatrix.trans. exp is __expf (ex2.approx of x log2 e,
//   as in the bf16 K1), whose error is far below bf16's.
// - fp32 (fp32 FMAs on the CUDA cores, no TF32), the dq and dk/dv kernels
//   of route (b) at every L: bound by operations at the vision shape,
//   159 us (10 B H L^2 d at 67 TFLOP/s). The same
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
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int PAD = 8;         // bf16 per smem row past HD: no bank conflicts
constexpr int KT = 64;         // rows of a streamed tile (route b)
constexpr int BF16_STAGES = 2;  // the ring: tile i + 1 copies while i runs
constexpr int MS = KT + 8;     // floats per row of a dq kernel mask tile

// A fragments of the 16 rows row0.. of a row-major [rows][HD] shared tile
// (row stride ld), by ldmatrix
template <int HD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[HD / 16][4],
                                       const __nv_bfloat16* tile, int ld,
                                       int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(a[kk][0], a[kk][1], a[kk][2], a[kk][3],
                tile + (row0 + lane % 16) * ld + kk * 16 + (lane / 16) * 8);
}

// c0, c1 = A x T^T for the 16 rows of A and rows key0 .. key0 + 15 of the
// row-major shared tile T ([key][HD], stride ld): a score-shaped product,
// T's rows are the output columns (8 each in c0, c1)
template <int HD>
__device__ __forceinline__ void score_chunk(float (&c0)[4], float (&c1)[4],
                                            const uint32_t (&a)[HD / 16][4],
                                            const __nv_bfloat16* T, int ld,
                                            int key0, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4(b0, b1, b2, b3,
                T + (key0 + (lane / 16) * 8 + lane % 8) * ld + kk * 16 +
                    ((lane / 8) & 1) * 8);
    mma_bf16(c0, a[kk], b0, b1);
    mma_bf16(c1, a[kk], b2, b3);
  }
}

// acc += bf16(w) x T rows row0 .. row0 + 15 ([rows][HD], stride ld),
// contracting over those 16 rows: w0, w1 are the two 8-column halves of a
// [16, 16] fp32 accumulator fragment, re-packed as the bf16 A operand
// (the rounding the JAX kernel applies to P and ds); B by ldmatrix.trans
template <int HD>
__device__ __forceinline__ void acc_chunk(float (&acc)[HD / 8][4],
                                          const float (&w0)[4],
                                          const float (&w1)[4],
                                          const __nv_bfloat16* T, int ld,
                                          int row0, int lane) {
  const uint32_t wa[4] = {pack_bf16(w0[0], w0[1]), pack_bf16(w0[2], w0[3]),
                          pack_bf16(w1[0], w1[1]), pack_bf16(w1[2], w1[3])};
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    uint32_t b0, b1, b2, b3;  // B fragments of d-tiles n, n+1
    ldmatrix_x4_trans(b0, b1, b2, b3,
                      T + (row0 + lane % 16) * ld + n * 8 + (lane / 16) * 8);
    mma_bf16(acc[n], wa, b0, b1);
    mma_bf16(acc[n + 1], wa, b2, b3);
  }
}

// acc += S^T x T over the 16 rows k0 .. k0 + 15 of S and T: S a row-major
// bf16 shared tile ([k][m], stride lds) whose columns m0 .. m0 + 15 are
// this warp's output rows, read transposed by ldmatrix.trans as the A
// operand; T ([k][HD], stride ldt) by ldmatrix.trans as B
template <int HD>
__device__ __forceinline__ void acc_trans_chunk(float (&acc)[HD / 8][4],
                                                const __nv_bfloat16* S,
                                                int lds, int m0, int k0,
                                                const __nv_bfloat16* T,
                                                int ldt, int lane) {
  uint32_t a[4];
  ldmatrix_x4_trans(a[0], a[1], a[2], a[3],
                    S + (k0 + (lane / 16) * 8 + lane % 8) * lds + m0 +
                        ((lane / 8) & 1) * 8);
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4_trans(b0, b1, b2, b3,
                      T + (k0 + lane % 16) * ldt + n * 8 + (lane / 16) * 8);
    mma_bf16(acc[n], a, b0, b1);
    mma_bf16(acc[n + 1], a, b2, b3);
  }
}

// rows r0 and r0 + 8 (those below L) of a [16, HD] fp32 fragment, times
// `mul`, to bf16 columns 2t .. of the row-major output at p (row stride
// `stride`)
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* p, long long stride,
                                           const float (&acc)[HD / 8][4],
                                           float mul, int r0, int L) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(p + r0 * stride + n * 8) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(p + (r0 + 8) * stride + n * 8) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// the max (SUM false) or sum over the 4 threads of a quad, which share
// the rows of an accumulator fragment
template <bool SUM>
__device__ __forceinline__ float quad_reduce(float v) {
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = SUM ? v + w : fmaxf(v, w);
  }
  return v;
}

// Route (a), L <= 16 NW: a block of NW warps per (head, batch row) holds
// all of the head's q, k, v, g and the [L, L] mask in shared memory. Warp w
// owns query rows 16 w .. for S = q k^T (every key present: a whole-row
// softmax),
// dP = g v^T, ds and dq, and key rows 16 w .. for dk and dv, which read
// bf16 P and ds back from shared memory transposed.
template <int HD, int NW>
struct Fused {
  static constexpr int LP = 16 * NW;    // rows and keys, padded
  static constexpr int KS = HD + PAD;   // bf16 per q / k / v / g row
  static constexpr int PS = LP + 8;     // bf16 per P / ds row
  static constexpr int MLD = LP + 4;    // floats per mask row
  static constexpr int TILE = LP * KS;  // bf16 per q / k / v / g tile
  static constexpr int HEAD = 4 * TILE + 2 * LP * PS;  // bf16 per head
  static constexpr int THREADS = 32 * NW;
  static constexpr size_t SMEM = (size_t)HEAD * 2 + LP * MLD * 4;
};

template <int HD, int NW>
__global__ void __launch_bounds__(Fused<HD, NW>::THREADS)
    mha_qkv_bwd_fused_bf16(const __nv_bfloat16* __restrict__ qkv,
                           const float* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ grad,
                           __nv_bfloat16* __restrict__ dqkv, int L, int D,
                           float scale) {
  using F = Fused<HD, NW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ms = reinterpret_cast<float*>(qs + F::HEAD);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride + h * HD;
  load_tile<F::LP, HD>(qs, base, stride, 0, L, F::THREADS);
  load_tile<F::LP, HD>(qs + F::TILE, base + D, stride, 0, L, F::THREADS);
  load_tile<F::LP, HD>(qs + 2 * F::TILE, base + 2 * D, stride, 0, L,
                       F::THREADS);
  load_tile<F::LP, HD>(qs + 3 * F::TILE, grad + (long long)b * L * D + h * HD,
                       D, 0, L, F::THREADS);
  load_mask(ms, F::MLD, mask, L, 0, F::LP, 0, F::LP, F::THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  __nv_bfloat16* ks = qs + F::TILE;
  __nv_bfloat16* vs = ks + F::TILE;
  __nv_bfloat16* gs = vs + F::TILE;
  __nv_bfloat16* ps = gs + F::TILE;
  __nv_bfloat16* dss = ps + F::LP * F::PS;

  const int row0 = warp * 16;  // this warp's query rows, then its keys
  float s[2 * NW][4], dp[2 * NW][4];
  {
    uint32_t qa[HD / 16][4], ga[HD / 16][4];
    ldsm_a<HD>(qa, qs, F::KS, row0, lane);
    ldsm_a<HD>(ga, gs, F::KS, row0, lane);
#pragma unroll
    for (int np = 0; np < NW; ++np) {
      score_chunk<HD>(s[2 * np], s[2 * np + 1], qa, ks, F::KS, np * 16, lane);
      score_chunk<HD>(dp[2 * np], dp[2 * np + 1], ga, vs, F::KS, np * 16,
                      lane);
    }
  }
  // s = (q k^T) scale + mask; keys past L get no weight
  const float* m0 = ms + (row0 + g) * F::MLD;
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int n = 0; n < 2 * NW; ++n) {
    const int c = n * 8 + 2 * t;
    const float2 a0 = *reinterpret_cast<const float2*>(m0 + c);
    const float2 a1 = *reinterpret_cast<const float2*>(m0 + 8 * F::MLD + c);
    const float mk[4] = {a0.x, a0.y, a1.x, a1.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = c + (e & 1) < L ? s[n][e] * scale + mk[e] : -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i] = quad_reduce<false>(mx[i]);
#pragma unroll
  for (int n = 0; n < 2 * NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = __expf(s[n][e] - mx[e / 2]);
      l[e / 2] += s[n][e];
    }
  float inv_l[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) inv_l[i] = 1.f / quad_reduce<true>(l[i]);
#pragma unroll
  for (int n = 0; n < 2 * NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] *= inv_l[e / 2];  // P, fp32
      delta[e / 2] += s[n][e] * dp[n][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) delta[i] = quad_reduce<true>(delta[i]);
  // ds = P (dp - rowsum(dp P)); P and ds to shared memory in bf16
  __nv_bfloat16* prow = ps + (row0 + g) * F::PS + 2 * t;
  __nv_bfloat16* drow = dss + (row0 + g) * F::PS + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * NW; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - delta[e / 2]);
    *reinterpret_cast<uint32_t*>(prow + n * 8) = pack_bf16(s[n][0], s[n][1]);
    *reinterpret_cast<uint32_t*>(prow + 8 * F::PS + n * 8) =
        pack_bf16(s[n][2], s[n][3]);
    *reinterpret_cast<uint32_t*>(drow + n * 8) = pack_bf16(dp[n][0], dp[n][1]);
    *reinterpret_cast<uint32_t*>(drow + 8 * F::PS + n * 8) =
        pack_bf16(dp[n][2], dp[n][3]);
  }
  __nv_bfloat16* out = dqkv + (long long)b * L * stride + h * HD + 2 * t;
  {  // dq = scale bf16(ds) k
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < NW; ++kc)
      acc_chunk<HD>(acc, dp[2 * kc], dp[2 * kc + 1], ks, F::KS, kc * 16,
                    lane);
    store_rows<HD>(out, stride, acc, scale, row0 + g, L);
  }
  __syncthreads();  // every warp's P and ds rows are in shared memory
  // this warp's keys: dv = bf16(P)^T g, dk = scale bf16(ds)^T q
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
#pragma unroll
  for (int qc = 0; qc < NW; ++qc) {
    acc_trans_chunk<HD>(dv, ps, F::PS, row0, qc * 16, gs, F::KS, lane);
    acc_trans_chunk<HD>(dk, dss, F::PS, row0, qc * 16, qs, F::KS, lane);
  }
  store_rows<HD>(out + D, stride, dk, scale, row0 + g, L);
  store_rows<HD>(out + 2 * D, stride, dv, 1.f, row0 + g, L);
}

// Route (b), L > 64: blocks of NW warps x 16 rows; one block owns query
// rows (dq kernel) or key rows (dk/dv kernel) of one head, stages them
// once and streams the other side in 64-row tiles through a two-stage
// cp.async ring with its mask tile (and, for dk/dv, the rows' statistics).
template <int HD, int NW>
struct Tiled {
  static constexpr int ROWS = 16 * NW;
  static constexpr int KS = HD + PAD;
  static constexpr int OWN = ROWS * KS;   // bf16 per own-rows tile
  static constexpr int STREAM = KT * KS;  // bf16 per streamed tile
  static constexpr int MT = ROWS + 4;     // floats per dk/dv mask row
  static constexpr size_t DQ_STAGE = (size_t)2 * STREAM * 2 + ROWS * MS * 4;
  static constexpr size_t DKDV_STAGE =
      (size_t)2 * STREAM * 2 + KT * MT * 4 + 3 * KT * 4;
  static constexpr size_t SMEM_DQ =
      (size_t)2 * OWN * 2 + BF16_STAGES * DQ_STAGE;
  static constexpr size_t SMEM_DKDV =
      (size_t)2 * OWN * 2 + BF16_STAGES * DKDV_STAGE;
};

// dq for ROWS query rows of one head. Pass 1 walks the key tiles from the
// last to the first, keeping each row's softmax max m, sum l and
// Delta = rowsum(dp o P) online (rescaled with the running max as l is),
// and stores (m, 1 / l, Delta) for the dk/dv kernel; pass 2 starts with
// tile 0, whose scores are still in registers, and accumulates
// dq = scale bf16(ds) k over tiles 0 .. n - 1: 2 n - 1 tiles in all.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32)
    mha_qkv_bwd_dq_bf16(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ grad,
                        __nv_bfloat16* __restrict__ dqkv,
                        float* __restrict__ stats, int L, int D, int H,
                        float scale) {
  using T = Tiled<HD, NW>;
  constexpr int THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = qs + T::OWN;
  unsigned char* ring = reinterpret_cast<unsigned char*>(gs + T::OWN);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * T::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row0 = warp * 16;  // this warp's rows within the block
  const bool active = q0 + row0 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride + h * HD;
  const int n = (L + KT - 1) / KT, total = 2 * n - 1;
  auto tile_of = [&](int i) { return i < n ? n - 1 - i : i - n + 1; };
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % BF16_STAGES) * T::DQ_STAGE;
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(st);
    const int k0 = tile_of(i) * KT;
    load_tile<KT, HD>(kt, base + D, stride, k0, L, THREADS);
    load_tile<KT, HD>(kt + T::STREAM, base + 2 * D, stride, k0, L, THREADS);
    load_mask(reinterpret_cast<float*>(kt + 2 * T::STREAM), MS, mask, L, q0,
              T::ROWS, k0, KT, THREADS);
  };
  load_tile<T::ROWS, HD>(qs, base, stride, q0, L, THREADS);
  load_tile<T::ROWS, HD>(gs, grad + (long long)b * L * D + h * HD, D, q0, L,
                         THREADS);
  issue(0);
  cp_async_commit();

  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float dq[HD / 8][4] = {};
  float s[KT / 8][4], dp[KT / 8][4];

  for (int i = 0; i < total; ++i) {
    cp_async_wait<BF16_STAGES - 2>();  // this thread's copies of tile i
    __syncthreads();  // everyone's; and tile i - 1 is consumed
    if (i + 1 < total) issue(i + 1);  // into tile i - 1's stage
    cp_async_commit();
    if (!active) continue;
    if (i == 0) {
      ldsm_a<HD>(qa, qs, T::KS, row0, lane);
      ldsm_a<HD>(ga, gs, T::KS, row0, lane);
    }
    const unsigned char* st = ring + (i % BF16_STAGES) * T::DQ_STAGE;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* vt = kt + T::STREAM;
    const float* mrow =
        reinterpret_cast<const float*>(vt + T::STREAM) + (row0 + g) * MS;
    const int k0 = tile_of(i) * KT, nk = min(KT, L - k0);

    // one visit of a tile; a full tile compiles without the 16-key guards
    auto visit = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        if (FULL || np * 16 < nk) {
          score_chunk<HD>(s[2 * np], s[2 * np + 1], qa, kt, T::KS, np * 16,
                          lane);
          score_chunk<HD>(dp[2 * np], dp[2 * np + 1], ga, vt, T::KS,
                          np * 16, lane);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nn = 2 * np + half, c = nn * 8 + 2 * t;
          if (!FULL && np * 16 >= nk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[nn][e] = -INFINITY;
              dp[nn][e] = 0.f;
            }
            continue;
          }
          const float2 a0 = *reinterpret_cast<const float2*>(mrow + c);
          const float2 a1 = *reinterpret_cast<const float2*>(mrow + 8 * MS + c);
          const float mk[4] = {a0.x, a0.y, a1.x, a1.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nn][e] = FULL || c + (e & 1) < nk ? s[nn][e] * scale + mk[e]
                                                : -INFINITY;
        }
      }
      if (i < n) {  // pass 1: the running statistics
        float tmax[2] = {row_reduce<false>(s, 0), row_reduce<false>(s, 1)};
        float alpha[2], rsum[2] = {0.f, 0.f}, rdot[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_reduce<false>(tmax[r]));
          alpha[r] = __expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int nn = 0; nn < KT / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[nn][e] - m[e / 2]);
            rsum[e / 2] += p;
            rdot[e / 2] += p * dp[nn][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * alpha[r] + quad_reduce<true>(rsum[r]);
          dsum[r] = dsum[r] * alpha[r] + quad_reduce<true>(rdot[r]);
        }
      }
      if (i == n - 1) {  // tile 0: the statistics are final
        const long long bhl = (long long)gridDim.z * H * L;
        float* sp = stats + ((long long)b * H + h) * L;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.f / l[r];  // l >= 1: the max contributes exp(0)
          delta[r] = dsum[r] * inv_l[r];
          const int row = q0 + row0 + g + 8 * r;
          if (t == 0 && row < L) {
            sp[row] = m[r];
            sp[bhl + row] = inv_l[r];
            sp[2 * bhl + row] = delta[r];
          }
        }
      }
      if (i >= n - 1) {  // pass 2: ds and dq += bf16(ds) k
#pragma unroll
        for (int nn = 0; nn < KT / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[nn][e] - m[e / 2]) * inv_l[e / 2];
            s[nn][e] = p * (dp[nn][e] - delta[e / 2]);
          }
#pragma unroll
        for (int kc = 0; kc < KT / 16; ++kc)
          if (FULL || kc * 16 < nk)
            acc_chunk<HD>(dq, s[2 * kc], s[2 * kc + 1], kt, T::KS, kc * 16,
                          lane);
      }
    };
    if (nk == KT)
      visit(std::true_type{});
    else
      visit(std::false_type{});
  }
  if (active)
    store_rows<HD>(dqkv + (long long)b * L * stride + h * HD + 2 * t, stride,
                   dq, scale, q0 + row0 + g, L);
}

// dk and dv for ROWS key rows of one head: the accumulator rows are keys
// and its columns the queries of the streamed tile (s^T, dp^T, P^T, ds^T),
// P recomputed from the dq kernel's statistics.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32)
    mha_qkv_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ grad,
                          __nv_bfloat16* __restrict__ dqkv,
                          const float* __restrict__ stats, int L, int D,
                          int H, float scale) {
  using T = Tiled<HD, NW>;
  constexpr int THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + T::OWN;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + T::OWN);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_blk = blockIdx.x * T::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row0 = warp * 16;  // this warp's keys within the block
  const bool active = k_blk + row0 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride + h * HD;
  const __nv_bfloat16* gb = grad + (long long)b * L * D + h * HD;
  const long long bhl = (long long)gridDim.z * H * L;
  const float* sp = stats + ((long long)b * H + h) * L;
  const int n = (L + KT - 1) / KT;
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % BF16_STAGES) * T::DKDV_STAGE;
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(st);
    float* mt = reinterpret_cast<float*>(qt + 2 * T::STREAM);
    float* s3 = mt + KT * T::MT;
    const int q0 = i * KT;
    load_tile<KT, HD>(qt, base, stride, q0, L, THREADS);
    load_tile<KT, HD>(qt + T::STREAM, gb, D, q0, L, THREADS);
    // mask rows: the tile's queries; columns: this block's keys
    load_mask(mt, T::MT, mask, L, q0, KT, k_blk, T::ROWS, THREADS);
    for (int j = threadIdx.x; j < 3 * KT; j += THREADS) {
      const int row = q0 + j % KT;
      const bool ok = row < L;
      cp_async4(s3 + j, ok ? sp + (j / KT) * bhl + row : sp, ok);
    }
  };
  load_tile<T::ROWS, HD>(ks, base + D, stride, k_blk, L, THREADS);
  load_tile<T::ROWS, HD>(vs, base + 2 * D, stride, k_blk, L, THREADS);
  issue(0);
  cp_async_commit();

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  for (int i = 0; i < n; ++i) {
    cp_async_wait<BF16_STAGES - 2>();
    __syncthreads();
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    if (!active) continue;
    if (i == 0) {
      ldsm_a<HD>(ka, ks, T::KS, row0, lane);
      ldsm_a<HD>(va, vs, T::KS, row0, lane);
    }
    const unsigned char* st = ring + (i % BF16_STAGES) * T::DKDV_STAGE;
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* gt = qt + T::STREAM;
    const float* mt = reinterpret_cast<const float*>(qt + 2 * T::STREAM);
    const float* s3 = mt + KT * T::MT;
    const int q0 = i * KT, nq = min(KT, L - q0);

    auto visit = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
      float p[KT / 8][4], ds[KT / 8][4];
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        if (FULL || np * 16 < nq) {
          score_chunk<HD>(p[2 * np], p[2 * np + 1], ka, qt, T::KS, np * 16,
                          lane);  // s^T = k q^T
          score_chunk<HD>(ds[2 * np], ds[2 * np + 1], va, gt, T::KS,
                          np * 16, lane);  // dp^T = v g^T
        }
      }
#pragma unroll
      for (int nn = 0; nn < KT / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nn * 8 + 2 * t + (e & 1);  // query within the tile
          if (FULL || c < nq) {
            const float mk = mt[c * T::MT + row0 + g + 8 * (e / 2)];
            const float pv =
                __expf(p[nn][e] * scale + mk - s3[c]) * s3[KT + c];
            p[nn][e] = pv;
            ds[nn][e] = pv * (ds[nn][e] - s3[2 * KT + c]);
          } else {
            p[nn][e] = ds[nn][e] = 0.f;
          }
        }
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc)
        if (FULL || kc * 16 < nq) {
          acc_chunk<HD>(dv, p[2 * kc], p[2 * kc + 1], gt, T::KS, kc * 16,
                        lane);  // dv += bf16(P)^T g
          acc_chunk<HD>(dk, ds[2 * kc], ds[2 * kc + 1], qt, T::KS, kc * 16,
                        lane);  // dk += bf16(ds)^T q
        }
    };
    if (nq == KT)
      visit(std::true_type{});
    else
      visit(std::false_type{});
  }
  if (!active) return;
  __nv_bfloat16* out = dqkv + (long long)b * L * stride + D + h * HD + 2 * t;
  store_rows<HD>(out, stride, dk, scale, k_blk + row0 + g, L);
  store_rows<HD>(out + D, stride, dv, 1.f, k_blk + row0 + g, L);
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

using bf16 = __nv_bfloat16;

// one block per (head, batch row): two heads a block (the mask copied
// once for both) were 3-5% slower at L 16 and 32 on the H100 (PERF.md)
template <int HD, int NW>
cudaError_t launch_fused(const bf16* qkv, const float* mask, const bf16* grad,
                         bf16* dqkv, int B, int L, int D, int H, float scale,
                         cudaStream_t stream) {
  using F = Fused<HD, NW>;
  static size_t allowed = 0;
  auto kernel = mha_qkv_bwd_fused_bf16<HD, NW>;
  const cudaError_t err = allow_smem(kernel, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), F::THREADS, F::SMEM, stream>>>(qkv, mask, grad, dqkv,
                                                      L, D, scale);
  return cudaGetLastError();
}

template <int HD, int NW>
cudaError_t launch_tiled(const bf16* qkv, const float* mask, const bf16* grad,
                         bf16* dqkv, float* stats, int B, int L, int D, int H,
                         float scale, cudaStream_t stream) {
  using T = Tiled<HD, NW>;
  static size_t allowed_dq = 0, allowed_dkdv = 0;
  auto dq = mha_qkv_bwd_dq_bf16<HD, NW>;
  auto dkdv = mha_qkv_bwd_dkdv_bf16<HD, NW>;
  cudaError_t err = allow_smem(dq, T::SMEM_DQ, allowed_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv, T::SMEM_DKDV, allowed_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + T::ROWS - 1) / T::ROWS, H, B);
  dq<<<grid, NW * 32, T::SMEM_DQ, stream>>>(qkv, mask, grad, dqkv, stats, L,
                                             D, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<grid, NW * 32, T::SMEM_DKDV, stream>>>(qkv, mask, grad, dqkv, stats,
                                                 L, D, H, scale);
  return cudaGetLastError();
}

// the longest L route (a) takes: one block holds the whole head
constexpr int FUSED_MAX_L = 64;

template <int HD>
cudaError_t launch_bf16(const bf16* qkv, const float* mask, const bf16* grad,
                        bf16* dqkv, float* stats, int B, int L, int D, int H,
                        float scale, cudaStream_t stream) {
  if (L <= FUSED_MAX_L) {  // one warp per 16 rows: 1, 2 or 4
    if (L <= 16)
      return launch_fused<HD, 1>(qkv, mask, grad, dqkv, B, L, D, H, scale,
                                 stream);
    if (L <= 32)
      return launch_fused<HD, 2>(qkv, mask, grad, dqkv, B, L, D, H, scale,
                                 stream);
    return launch_fused<HD, 4>(qkv, mask, grad, dqkv, B, L, D, H, scale,
                               stream);
  }
  // 4 warps a block, 2 where 4 would leave SMs idle (one-warp blocks
  // spilled in the dq kernel at head dim 16 on __expf)
  if ((long long)((L + 63) / 64) * H * B >= SMS)
    return launch_tiled<HD, 4>(qkv, mask, grad, dqkv, stats, B, L, D, H,
                               scale, stream);
  return launch_tiled<HD, 2>(qkv, mask, grad, dqkv, stats, B, L, D, H, scale,
                             stream);
}

template <int HD>
cudaError_t launch(const void* qkv, const float* mask, const void* grad,
                   void* dqkv, float* stats, int B, int L, int D, int H,
                   int dtype, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (dtype == 1)
    return launch_bf16<HD>(static_cast<const bf16*>(qkv), mask,
                           static_cast<const bf16*>(grad),
                           static_cast<bf16*>(dqkv), stats, B, L, D, H, scale,
                           stream);
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

// 1 where the launcher takes route (a), the fused kernel, for sequence
// length L and dtype (0: float32, 1: bfloat16), else 0 (route (b)).
extern "C" int mha_qkv_bwd_fused(int L, int dtype) {
  return dtype == 1 && L <= FUSED_MAX_L;
}

// qkv [B, L, 3D] and grad [B, L, D] (dtype 0: float32, 1: bfloat16; both
// 16-byte aligned), mask [L, L] float32, dqkv [B, L, 3D] of qkv's dtype,
// stats float32 scratch of 3 * B * H * L (unused by bf16 at L <= 64); all
// contiguous on the current device, head dim D / H in {16, 32, 64}.
// Returns the launches' cudaError_t (0 on success); does not synchronise.
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
