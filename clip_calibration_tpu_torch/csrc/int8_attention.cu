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
// Bound on an H100 SXM at the main shape (the probe's: B 256, L 208, D 768,
// H 12, the batch-256 ViT-B/16 serving attention): bytes. qkv 245.4 MB +
// mask 0.17 MB in, out 81.8 MB = 327.3 MB, 97.7 us at 3.35 TB/s, against
// 4 B H L^2 d = 34.0 G operations, 34.4 us at the bf16 tensor-core peak
// and 17.2 us at the int8 one.
//
// DRAM and L2 per call at that shape: qkv is read from DRAM once and the
// output written once (327.3 MB). From L2 a block reads the q, k and v of
// each of its heads once (79.9 KB a head; int8_qk_pv reads v twice, for sv
// and to quantize it) and its mask rows once for all its heads and passes
// (173 KB; at this shape a block walks 4 heads): about 0.38 GB a call for
// fp32_scores and int8_qk and 0.46 GB for int8_qk_pv, over 768 blocks. The
// design before this one read k, v and the mask per 64-query tile and per
// pass: about 2.8 GB.
//
// What the design does about it:
// - A block covers all the queries of its heads where 13 warps of 16 rows
//   reach (L <= 208), so each head's k and v come into the SM once. The
//   launcher splits the queries over more blocks only where B * H would
//   leave SMs idle (B 1: 13 blocks of 16 rows a head, 156 in all) or
//   shared memory runs out (long L); then the per-head work below is done
//   once per block. It groups HG heads of a batch row into a block (HG 4
//   at this shape) while the grid keeps four waves of the 132 SMs.
// - Where a block walks several heads, its mask rows are staged whole in
//   shared memory (173 KB at L 208) and serve every head and pass; else
//   the mask rows of each 64-key tile stream with the keys.
// - int8 variants: k is quantized once per key row, into an int8 copy that
//   stays in shared memory for the head (with its row scales); int8_qk_pv
//   reduces sv once (16-byte loads, maxima met by atomicMax) and quantizes
//   and transposes v once, into a second resident copy (about 150 KB for
//   both at L 1024, d 64). Each warp quantizes its own 16 q rows. The IEEE
//   divisions of quantization are paid once per element, not once per
//   block and pass.
// - fp32_scores and int8_qk make ONE pass over the keys: online softmax as
//   K1 (csrc/mha_qkv_fwd.cu), P rounded to bf16 unnormalised, normalised
//   once at the end. int8_qk_pv rounds the NORMALISED p, so it keeps two
//   passes (row max and sum, then p and P.V), both over the resident int8
//   copies: k and v are not read again. Its p = e / sum stays a division
//   per score (__fdiv_rn): a product with 1 / sum is not bit-equal to it.
// - K/V bf16 tiles (fp32_scores: k and v; int8_qk: v) arrive through a
//   two-stage cp.async ring with one barrier a tile: the copy of tile j + 1
//   is in flight while the warps compute tile j.
// - A ragged last tile costs what it holds, to 16 keys (32 for the int8
//   P.V).
// - exp is __expf (ex2.approx of x log2 e): its relative error, about 1e-6
//   at these scores, is far below a bf16 ulp.
//
// Products, all through mma.sync (attention_tile.cuh):
// - QK^T in bf16 (fp32_scores): m16n8k16, q's A fragments in registers,
//   k's B fragments by ldmatrix from the ring's bf16 tile.
// - QK^T in int8: m16n8k32.s8; the B operand is k's rows, the layout it
//   wants (ldmatrix on the int8 rows). int32 sums are exact (d 127^2 <
//   2^24).
// - P.V in bf16: the score fragments repacked as A, v's B fragments from
//   ldmatrix.trans.
// - P.V in int8: m16n8k32.s8 with the score fragments repacked as A. A
//   thread holds keys (2t, 2t+1, 2t+8, 2t+9) of each 16 for its rows, which
//   the mma reads as k positions (4t .. 4t+3): any permutation of k applied
//   to both operands leaves an integer sum unchanged, so v is stored
//   transposed ([d][key], 4 keys of one column per 32-bit word, as the s8
//   B operand wants and ldmatrix.trans cannot give for bytes) in that
//   permuted order. int32 sums are exact (L 127^2 < 2^24 for L <= 1024).
// - Keys past L are zeros in shared memory and get p = 0; query rows past
//   L are computed and never stored.
//
// Build without --use_fast_math (ops/build.py): every x / s is an IEEE
// division, every rounding half to even (__float2int_rn), and the scale
// products and sums use __fmul_rn / __fadd_rn so that nvcc does not
// contract them into FMAs, so the int8 values and the scores are the plain
// version's bit for bit.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

enum Variant { FP32_SCORES = 0, INT8_QK = 1, INT8_QK_PV = 2 };

constexpr int BK = 64;         // keys per ring tile
constexpr int MT = BK + 8;     // floats per row of a mask tile
constexpr int MAX_WARPS = 13;  // 208 query rows a block
constexpr int SMS = 132;
// one block an SM at most (the mask alone can take 173 KB): four waves
constexpr int FILL_BLOCKS = 4 * SMS;
constexpr int MAX_SMEM = 227 * 1024;

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

// Per-row int8 quantization by a pair of lanes (2i, 2i+1 of a warp; `half`
// = lane & 1, HD / 2 values each) of bf16 row `row` of src (row stride
// `stride`; a row at or past `rows` reads as zeros), x = the bf16 value
// times `mul` in fp32 when `scaled`: writes round(x / s) to dst (row of
// HD bytes; none when dst is null) and returns s = max|x| / 127 + 1e-30 to
// both lanes. Every lane of the warp must call it (a shuffle).
template <int HD>
__device__ __forceinline__ float quantize_row(const __nv_bfloat16* src,
                                              long long stride, int row,
                                              int rows, float mul, bool scaled,
                                              int8_t* dst, int half) {
  constexpr int HALF = HD / 2;
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
  if (dst != nullptr) {
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + half * HALF);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < HALF; i += 4)
        out[i / 4] = pack_s8(quant(x[i], s), quant(x[i + 1], s),
                             quant(x[i + 2], s), quant(x[i + 3], s));
    } else {  // a padding row: round(0 / s) = 0, no divisions
#pragma unroll
      for (int i = 0; i < HALF; i += 4) out[i / 4] = 0u;
    }
  }
  return s;
}

// Byte offsets of the dynamic shared memory of a block of `nw` warps at
// sequence length L: the mask (WHOLE: the block's rows for all keys, row
// stride mask_stride(L); else a ring of 64-key tiles), the bf16 K/V
// ring, k's row scales, v's column scales, the int8 k (rows of HD + 16
// bytes), the transposed int8 v (rows of LP + 16 bytes, LP = L to a
// multiple of 64) and the warps' int8 q rows (before them, int8_qk_pv's
// partial column maxima: at most max(HD, 32 nw) floats, which the q area
// always holds).
struct Smem {
  int mask, kv, sk, sv, k8, vt8, q8, total;
};

// ring depth: the copy of tile j + 1 overlaps the products on tile j (a
// third stage measured no faster on the H100)
constexpr int STAGES = 2;

__host__ __device__ inline int mask_stride(int L) { return (L + 15) / 16 * 16; }

template <int HD, int VAR, bool WHOLE>
__host__ __device__ inline Smem smem_layout(int nw, int L) {
  constexpr bool QK8 = VAR != FP32_SCORES, PV8 = VAR == INT8_QK_PV;
  const int rows = 16 * nw, lp = (L + BK - 1) / BK * BK;
  Smem s;
  s.mask = 0;
  s.kv = s.mask + (WHOLE ? rows * mask_stride(L) : STAGES * rows * MT) * 4;
  s.sk = s.kv + (PV8 ? 0 : STAGES * (QK8 ? 1 : 2) * BK * (HD + 8) * 2);
  s.sv = s.sk + (QK8 ? lp * 4 : 0);
  s.k8 = s.sv + (PV8 ? HD * 4 : 0);
  s.vt8 = s.k8 + (QK8 ? lp * (HD + 16) : 0);
  s.q8 = s.vt8 + (PV8 ? HD * (lp + 16) : 0);
  s.total = s.q8 + (QK8 ? rows * (HD + 16) : 0);
  return s;
}

// Fragment layouts: attention_tile.cuh. A block is blockDim.x / 32 warps,
// warp w owning query rows q0 + 16 w .. + 15 (q0 = blockIdx.x * 16 warps)
// of batch row blockIdx.z, for each of the HG heads blockIdx.y * HG .. in
// turn. WHOLE: the block's mask rows are staged once for all keys and
// serve every head; else HG is 1 and the mask streams with the keys.
template <int HD, int VAR, bool WHOLE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    int8_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int L, int D,
                          int HG, float scale) {
  constexpr bool QK8 = VAR != FP32_SCORES;
  constexpr bool PV8 = VAR == INT8_QK_PV;
  constexpr int KS = HD + 8;     // bf16 per row of a ring tile
  constexpr int KROW = HD + 16;  // bytes per row of the int8 q and k
  constexpr int KV = BK * KS;    // bf16 per ring tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, nw = threads / 32, rows = 16 * nw;
  const Smem S = smem_layout<HD, VAR, WHOLE>(nw, L);
  float* ms = reinterpret_cast<float*>(smem + S.mask);
  __nv_bfloat16* kvring = reinterpret_cast<__nv_bfloat16*>(smem + S.kv);
  float* sk = reinterpret_cast<float*>(smem + S.sk);
  float* svs = reinterpret_cast<float*>(smem + S.sv);
  int8_t* k8 = reinterpret_cast<int8_t*>(smem + S.k8);
  int8_t* vt8 = reinterpret_cast<int8_t*>(smem + S.vt8);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + S.q8);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h0 = blockIdx.y * HG, b = blockIdx.z, q0 = blockIdx.x * rows;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r1
  const int r1 = r0 + 8;
  const bool active = q0 + warp * 16 < L;
  const long long stride = 3LL * D;
  const __nv_bfloat16* base = qkv + (long long)b * L * stride;
  const int ntiles = (L + BK - 1) / BK, lp = ntiles * BK;
  const int vrow = lp + 16;  // bytes per row of the transposed int8 v
  const int per_head = (PV8 ? 2 : 1) * ntiles, total = HG * per_head;
  const int mld = WHOLE ? mask_stride(L) : MT;

  // tile i of the walk (head h0 + i / per_head, keys (i % ntiles) * BK ..):
  // the mask rows of this block unless staged whole, and the bf16 k and v
  // tiles the variant reads from the ring
  auto issue = [&](int i) {
    const int k0 = (i % ntiles) * BK;
    if constexpr (!WHOLE)
      load_mask(ms + (i % STAGES) * rows * MT, MT, mask, L, q0, rows, k0, BK,
                threads);
    if constexpr (!PV8) {
      const __nv_bfloat16* hb = base + (h0 + i / per_head) * HD;
      __nv_bfloat16* st = kvring + (i % STAGES) * (QK8 ? 1 : 2) * KV;
      if constexpr (!QK8) {
        load_tile<BK, HD>(st, hb + D, stride, k0, L, threads);
        st += KV;
      }
      load_tile<BK, HD>(st, hb + 2 * D, stride, k0, L, threads);
    }
  };
  if constexpr (WHOLE)
    load_mask(ms, mld, mask, L, q0, rows, 0, mld, threads);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }

  uint32_t qa[QK8 ? HD / 32 : HD / 16][4];  // q's A fragments, per head
  float sq0 = 0.f, sq1 = 0.f;
  float m[2], l[2];
  float o[HD / 8][4];
  int oi[PV8 ? HD / 8 : 1][4];

  // once per head, while the ring's copy of the next tile is in flight:
  // sv, the int8 k and v, this warp's q
  auto prologue = [&](const __nv_bfloat16* qb) {
    const __nv_bfloat16* kb = qb + D;
    const __nv_bfloat16* vb = qb + 2 * D;
    if constexpr (PV8) {
      // sv: each column's max |v| over the L keys. A thread takes 8
      // columns (one 16-byte load a row) of every (threads / (HD / 8))-th
      // key; the maxima meet in shared memory through atomicMax on their
      // bits (|v| >= 0: the integer order is the float order)
      constexpr int CG = HD / 8;  // 16-byte column groups
      unsigned* svbits = reinterpret_cast<unsigned*>(svs);
      for (int c = tid; c < HD; c += threads) svbits[c] = 0u;
      __syncthreads();
      {
        const int cg = tid % CG;
        float mx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int key = tid / CG; key < L; key += threads / CG) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(vb + key * stride + cg * 8);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx[j] = fmaxf(mx[j], fabsf(__bfloat162float(e[j])));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          atomicMax(&svbits[cg * 8 + j], __float_as_uint(mx[j]));
      }
      __syncthreads();
      for (int c = tid; c < HD; c += threads)
        svs[c] = __fadd_rn(__fdiv_rn(__uint_as_float(svbits[c]), 127.f),
                           1e-30f);
      __syncthreads();
      // v quantized per column and transposed, k positions permuted as the
      // P.V mma reads them: word w of row c holds keys
      // 16 (w / 4) + 2 (w % 4) + {0, 1, 8, 9}. A thread takes the word's 4
      // keys for 8 columns (four 16-byte loads); keys past L are zeros.
      for (int i = tid; i < CG * (lp / 4); i += threads) {
        const int cg = i % CG, w = i / CG;
        const int key = (w / 4) * 16 + 2 * (w % 4);
        if (key >= L) {  // the word's 4 keys are all padding: zeros
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(vt8 + (cg * 8 + j) * vrow + w * 4) =
                0u;
          continue;
        }
        const int keys[4] = {key, key + 1, key + 8, key + 9};
        uint4 u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          u[r] = keys[r] < L ? *reinterpret_cast<const uint4*>(
                                   vb + keys[r] * stride + cg * 8)
                             : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cg * 8 + j;
          const float sv = svs[c];
          int qv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            qv[r] = quant(__bfloat162float(
                              reinterpret_cast<const __nv_bfloat16*>(&u[r])[j]),
                          sv);
          *reinterpret_cast<uint32_t*>(vt8 + c * vrow + w * 4) =
              pack_s8(qv[0], qv[1], qv[2], qv[3]);
        }
      }
    }
    if constexpr (QK8) {
      // k: a pair of lanes per key row (every lane runs the same count of
      // steps: the shuffle needs the whole warp)
      for (int row0 = 0; row0 < lp; row0 += threads / 2) {
        const int row = row0 + tid / 2;
        const float s = quantize_row<HD>(kb, stride, row, L, 1.f, false,
                                         row < lp ? k8 + row * KROW : nullptr,
                                         tid & 1);
        if (row < lp && (tid & 1) == 0) sk[row] = s;
      }
    }
    if (!active) return;
    if constexpr (QK8) {
      // this warp's 16 rows, a pair of lanes each, scaled in fp32
      int8_t* qw = q8 + warp * 16 * KROW;
      const float s = quantize_row<HD>(qb, stride, q0 + warp * 16 + lane / 2,
                                       L, scale, true,
                                       qw + (lane / 2) * KROW, lane & 1);
      sq0 = __shfl_sync(0xffffffffu, s, 2 * g);
      sq1 = __shfl_sync(0xffffffffu, s, 2 * (g + 8));
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        const int8_t* p = qw + g * KROW + kk * 32 + 4 * t;
        qa[kk][0] = ld_u32(p);
        qa[kk][1] = ld_u32(p + 8 * KROW);
        qa[kk][2] = ld_u32(p + 16);
        qa[kk][3] = ld_u32(p + 8 * KROW + 16);
      }
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
  };

  for (int i = 0; i < total; ++i) {
    const int hh = i / per_head, ii = i % per_head;
    const int k0 = (ii % ntiles) * BK, nk = min(BK, L - k0);
    const bool second = PV8 && ii >= ntiles;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and tile i - 1 is consumed
    if (i + STAGES - 1 < total) issue(i + STAGES - 1);  // tile i - 1's stage
    cp_async_commit();
    if (ii == 0) {  // a new head
      prologue(base + (h0 + hh) * HD);
      m[0] = m[1] = -FLT_MAX;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[n][e] = 0.f;
          if constexpr (PV8) oi[n][e] = 0;
        }
      __syncthreads();  // the head's int8 k and v are in place
    }
    if (active) {
      const float* mrow =
          WHOLE ? ms + (warp * 16 + g) * mld + k0
                : ms + (i % STAGES) * rows * MT + (warp * 16 + g) * MT;
      const __nv_bfloat16* kst = kvring + (i % STAGES) * (QK8 ? 1 : 2) * KV;
      const __nv_bfloat16* vst = kst + (QK8 ? 0 : KV);

      // one step over the tile; a full tile (every tile but a ragged last
      // one) compiles without the 16-key guards, so the scheduler can
      // interleave its mma chains and exps across the whole tile
      auto step = [&](auto full) {
        constexpr bool FULL = decltype(full)::value;
        // scores of the 16-key chunks that hold a key < L (the rest -inf)
        float s[BK / 8][4];
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {  // n-tiles 2 np, 2 np + 1
          float acc[2][4] = {};
          if (FULL || np * 16 < nk) {
            // B fragments of both n-tiles: lanes 16 j + r address key row
            // 16 np + 8 j + r % 8, the r / 8-th half of the 16 (32) columns
            const int krow = np * 16 + (lane / 16) * 8 + lane % 8;
            if constexpr (QK8) {
              int ia[2][4] = {};
#pragma unroll
              for (int kk = 0; kk < HD / 32; ++kk) {
                uint32_t b0, b1, b2, b3;
                ldmatrix_x4(b0, b1, b2, b3, k8 + (k0 + krow) * KROW + kk * 32 +
                                                ((lane / 8) & 1) * 16);
                mma_s8(ia[0], qa[kk], b0, b1);
                mma_s8(ia[1], qa[kk], b2, b3);
              }
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int key = k0 + (2 * np + j) * 8 + 2 * t;
                const float sk0 = sk[key], sk1 = sk[key + 1];
                // si * (sq * sk), in that order
                acc[j][0] = __fmul_rn(float(ia[j][0]), __fmul_rn(sq0, sk0));
                acc[j][1] = __fmul_rn(float(ia[j][1]), __fmul_rn(sq0, sk1));
                acc[j][2] = __fmul_rn(float(ia[j][2]), __fmul_rn(sq1, sk0));
                acc[j][3] = __fmul_rn(float(ia[j][3]), __fmul_rn(sq1, sk1));
              }
            } else {
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t b0, b1, b2, b3;
                ldmatrix_x4(b0, b1, b2, b3,
                            kst + krow * KS + kk * 16 + ((lane / 8) & 1) * 8);
                mma_bf16(acc[0], qa[kk], b0, b1);
                mma_bf16(acc[1], qa[kk], b2, b3);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 2 * np + j;
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = -INFINITY;
            if (!FULL && np * 16 >= nk) continue;
            const int c = n * 8 + 2 * t;
            const float2 m0 = *reinterpret_cast<const float2*>(mrow + c);
            const float2 m1 =
                *reinterpret_cast<const float2*>(mrow + 8 * mld + c);
            const float mk[4] = {m0.x, m0.y, m1.x, m1.y};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = FULL || c + (e & 1) < nk ? __fadd_rn(acc[j][e], mk[e])
                                                 : -INFINITY;
          }
        }

        if (!second) {
          // online: each row's running max and sum of exp(s - max)
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
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = !FULL && (n / 2) * 16 >= nk
                            ? 0.f
                            : __expf(s[n][e] - m[e / 2]);
          float rsum[2] = {row_reduce<true>(s, 0), row_reduce<true>(s, 1)};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
            rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
            l[r] = l[r] * alpha[r] + rsum[r];
          }
          if constexpr (!PV8) {
            // one pass: P (unnormalised) in bf16 times v, rescaled as the
            // max moves
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
              o[n][0] *= alpha[0];
              o[n][1] *= alpha[0];
              o[n][2] *= alpha[1];
              o[n][3] *= alpha[1];
            }
#pragma unroll
            for (int kc = 0; kc < BK / 16; ++kc) {  // 16 keys per step
              if (!FULL && kc * 16 >= nk) continue;
              const uint32_t pa[4] = {
                  pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                  pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                  pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                  pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
              for (int n = 0; n < HD / 8; n += 2) {
                uint32_t vb0, vb1, vb2, vb3;  // B fragments of d-tiles n, n+1
                ldmatrix_x4_trans(
                    vb0, vb1, vb2, vb3,
                    vst + (kc * 16 + lane % 16) * KS + n * 8 + (lane / 16) * 8);
                mma_bf16(o[n], pa, vb0, vb1);
                mma_bf16(o[n + 1], pa, vb2, vb3);
              }
            }
          }
        } else if constexpr (PV8) {
          // second pass: p = exp(s - max) / sum, pi = round(p * 127), P.V
          int pi[BK / 8][4];
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pi[n][e] = FULL || (n / 2) * 16 < nk
                             ? __float2int_rn(__fmul_rn(
                                   __fdiv_rn(__expf(s[n][e] - m[e / 2]),
                                             l[e / 2]),
                                   127.f))
                             : 0;
#pragma unroll
          for (int ks32 = 0; ks32 < BK / 32; ++ks32) {  // 32 keys per step
            if (!FULL && ks32 * 32 >= nk) continue;
            const int n0 = ks32 * 4;
            const uint32_t pa[4] = {
                pack_s8(pi[n0][0], pi[n0][1], pi[n0 + 1][0], pi[n0 + 1][1]),
                pack_s8(pi[n0][2], pi[n0][3], pi[n0 + 1][2], pi[n0 + 1][3]),
                pack_s8(pi[n0 + 2][0], pi[n0 + 2][1], pi[n0 + 3][0],
                        pi[n0 + 3][1]),
                pack_s8(pi[n0 + 2][2], pi[n0 + 2][3], pi[n0 + 3][2],
                        pi[n0 + 3][3])};
#pragma unroll
            for (int dn = 0; dn < HD / 8; dn += 2) {  // d-tiles dn, dn + 1
              uint32_t b0, b1, b2, b3;
              ldmatrix_x4(b0, b1, b2, b3,
                          vt8 + (dn * 8 + (lane / 16) * 8 + lane % 8) * vrow +
                              k0 + ks32 * 32 + ((lane / 8) & 1) * 16);
              mma_s8(oi[dn], pa, b0, b1);
              mma_s8(oi[dn + 1], pa, b2, b3);
            }
          }
        }
      };
      if (nk == BK)
        step(std::true_type{});
      else
        step(std::false_type{});

      if (ii == per_head - 1) {  // the head's last tile: store its output
        __nv_bfloat16* ob =
            out + (long long)b * L * D + (h0 + hh) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          float y[4];
          if constexpr (PV8) {
            // oi * (sv / 127)
            const int c = n * 8 + 2 * t;
            const float f0 = __fdiv_rn(svs[c], 127.f);
            const float f1 = __fdiv_rn(svs[c + 1], 127.f);
            y[0] = __fmul_rn(float(oi[n][0]), f0);
            y[1] = __fmul_rn(float(oi[n][1]), f1);
            y[2] = __fmul_rn(float(oi[n][2]), f0);
            y[3] = __fmul_rn(float(oi[n][3]), f1);
          } else {
            // normalised once (l >= 1: the running max contributes exp(0))
            y[0] = __fdiv_rn(o[n][0], l[0]);
            y[1] = __fdiv_rn(o[n][1], l[0]);
            y[2] = __fdiv_rn(o[n][2], l[1]);
            y[3] = __fdiv_rn(o[n][3], l[1]);
          }
          if (r0 < L)
            *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + n * 8) =
                pack_bf16(y[0], y[1]);
          if (r1 < L)
            *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + n * 8) =
                pack_bf16(y[2], y[3]);
        }
      }
    }
  }
}

template <int HD, int VAR, bool WHOLE>
cudaError_t launch_kernel(dim3 grid, int nw, size_t smem, const void* qkv,
                          const float* mask, void* out, int L, int D, int hg,
                          float scale, cudaStream_t stream) {
  static size_t allowed = 0;
  auto kernel = int8_attention_kernel<HD, VAR, WHOLE>;
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask,
      static_cast<__nv_bfloat16*>(out), L, D, hg, scale);
  return cudaGetLastError();
}

template <int HD, int VAR>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B,
                   int L, int D, int H, cudaStream_t stream) {
  // the JAX code's 1.0 / d ** 0.5, in double, then as fp32
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  // warps a block: all the query tiles of a head (up to 13), fewer where
  // the (batch row, head) pairs alone would leave SMs idle, or where
  // shared memory would not hold the block
  const int tiles16 = (L + 15) / 16;
  const long long heads = (long long)B * H;
  const int need = heads >= SMS ? 1 : (int)((SMS + heads - 1) / heads);
  int nw = std::max(1, std::min(MAX_WARPS, tiles16 / need));
  while (nw > 1 && smem_layout<HD, VAR, true>(nw, L).total > MAX_SMEM &&
         smem_layout<HD, VAR, false>(nw, L).total > MAX_SMEM)
    --nw;
  const int chunks = (tiles16 + nw - 1) / nw;
  // a block walks the most heads that still give the grid four waves;
  // where it walks more than one (or the ring of mask tiles would not
  // fit), its mask rows are staged whole and serve every head
  int hg = 1;
  for (int c = H; c > 1; --c)
    if (H % c == 0 && (long long)chunks * (H / c) * B >= FILL_BLOCKS) {
      hg = c;
      break;
    }
  const size_t whole = smem_layout<HD, VAR, true>(nw, L).total;
  const size_t smem = smem_layout<HD, VAR, false>(nw, L).total;
  if (whole <= MAX_SMEM && (hg > 1 || smem > MAX_SMEM))
    return launch_kernel<HD, VAR, true>(dim3(chunks, H / hg, B), nw, whole,
                                        qkv, mask, out, L, D, hg, scale,
                                        stream);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  return launch_kernel<HD, VAR, false>(dim3(chunks, H, B), nw, smem, qkv,
                                       mask, out, L, D, 1, scale, stream);
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
