// Tile code shared by the port's attention kernels (K1 csrc/mha_qkv_fwd.cu,
// K2 csrc/mha_qkv_bwd.cu, K4 csrc/int8_attention.cu) and K3
// (csrc/int8_matmul.cu, which takes the cp.async copies, bf16 packing and
// allow_smem): the mma.sync wrappers, fragment loads, and cp.async copies
// that fill the two-stage tile rings the redesigned K1, K2 and K4 stream
// keys through; and the fp32 register micro-tiles of the fp32 K1 and K2
// (end of the file).
//
// Fragment layouts (PTX ISA): g = lane / 4, t = lane % 4.
// m16n8k16 bf16: A a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8..).
// m16n8k32 s8: A a0 (g, 4t..4t+3), a1 (g+8, ..), a2 (g, 16+4t..),
// a3 (g+8, 16+4t..); B b0 (k 4t..4t+3, n g), b1 (k 16+4t..).
// C (both): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, ..).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn_tile {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k8 bf16 (a head dim that is 8 past a multiple of 16: its last 8
// columns): A a0 (g, 2t..2t+1), a1 (g+8, ..); B b0 (k 2t..2t+1, n g).
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
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

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and each thread receives, per matrix, the pair
// (row g; columns 2t, 2t+1): the B fragment of a tile stored [n][k] (k's
// rows for S = Q K^T; for int8, 4 bytes: k 4t..4t+3 of row g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Two 8x8 b16 matrices, as ldmatrix_x4's first two (lanes 0..15 give the
// row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// Two transposed 8x8 bf16 matrices, as ldmatrix_x4_trans's first two.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// Four transposed 8x8 bf16 matrices from shared memory: lanes 8i..8i+7
// give the row addresses of matrix i, and each thread receives, per
// matrix, the pair (rows 2t, 2t+1; column g): the B fragment of a
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

// The max (SUM false) or sum of one row's values in a thread's S
// fragments s[8][4] (row r: elements 2r, 2r + 1 of each n-tile), as a
// tree rather than a chain of 16 dependent operations.
template <bool SUM>
__device__ __forceinline__ float row_reduce(const float (&s)[8][4], int r) {
  float v[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    v[n] = SUM ? s[n][2 * r] + s[n][2 * r + 1]
               : fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n)
      v[n] = SUM ? v[n] + v[n + w] : fmaxf(v[n], v[n + w]);
  return v[0];
}

// 16 bytes from global to shared memory, bypassing L1 (.cg); with
// `valid` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(n));
}

// 4 bytes (for rows whose starts are not 16-byte aligned), through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// bf16 per shared-memory row of a [rows, HD] tile: HD padded so that a
// row is an odd number of 16-byte units (HD + 8 for HD 16, 32, 64; HD + 16
// for 104), so the 8 row addresses of an ldmatrix, and the fragment reads,
// fall on distinct banks.
__host__ __device__ constexpr int smem_row(int hd) {
  return (hd / 8) % 2 ? hd + 16 : hd + 8;
}

// cp.async copy of rows [row0, row0 + ROWS) x [0, HD) of a strided bf16
// slice into a ROWS x HD tile in shared memory, row stride KS (default
// smem_row(HD)). Rows at or past `rows` are zero-filled. Every thread of
// the block issues its share; the caller commits. The kernels keep two
// such tiles per operand, a ring: the copy of key tile j + 1 is in flight
// while the warps compute tile j.
template <int ROWS, int HD, int KS = smem_row(HD)>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows, int threads) {
  constexpr int CHUNKS = ROWS * HD / 8;
  for (int i = threadIdx.x; i < CHUNKS; i += threads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * KS + c, ok ? src + row * stride + c : src, ok);
  }
}

// mask rows [row0, row0 + rows) x keys [k0, k0 + cols) of the [L, L] mask
// into dst (row stride `ld` floats) by cp.async; entries past L are zeros.
// 16-byte copies when every row start is 16-byte aligned (L % 4 == 0).
__device__ __forceinline__ void load_mask(float* dst, int ld,
                                          const float* mask, int L, int row0,
                                          int rows, int k0, int cols,
                                          int threads) {
  if ((L & 3) == 0) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += threads) {
      const int r = i / per_row, c = (i % per_row) * 4;
      const int row = row0 + r, key = k0 + c;
      const bool ok = row < L && key < L;
      cp_async16(dst + r * ld + c,
                 ok ? mask + (long long)row * L + key : mask, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += threads) {
      const int r = i / cols, c = i % cols, row = row0 + r, key = k0 + c;
      const bool ok = row < L && key < L;
      cp_async4(dst + r * ld + c,
                ok ? mask + (long long)row * L + key : mask, ok);
    }
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory (above 48 KB it
// must ask), once per kernel and size: `allowed` is the kernel's own
// record.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// fp32 micro-tiles (the fp32 instances of K1 and K2: full fp32 FMAs on the
// CUDA cores, no tensor cores, so no TF32)
// ---------------------------------------------------------------------------
//
// A block of 16 TY threads covers 4 TY rows: thread (ty, tx) = (tid / 16,
// tid % 16) owns rows 4 ty .. 4 ty + 3. Of a 64-column score tile (keys,
// or in K2's dk/dv kernel queries) it owns columns tx + 16 j, j = 0..3;
// of a [rows, HD] product, columns tx TN .. tx TN + TN - 1 (TN = HD / 16).
// The 16 threads that share rows are one half of a warp, so row
// reductions are __shfl_xor_sync over lanes 8, 4, 2, 1 and a tile of P
// written by them needs only __syncwarp before they read it back.
// Shared-memory rows are padded by 4 floats: the float4 reads of 16
// consecutive rows (tx + 16 j) then fall on distinct bank groups, 8 rows
// per wavefront, and the 4 rows of one thread are broadcast.

constexpr int F32_TILE = 64;          // columns of a score tile
constexpr int F32_PS = F32_TILE + 4;  // floats per row of a P / ds tile

template <int N>
__device__ __forceinline__ void ld_f32(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// acc[i][j] += sum_c a[i][c] b[16 j][c] over c < HD: the thread's 4 rows of
// one operand (a: its first row) against its 4 columns of the other
// (b: row tx of the tile), both row-major with `stride` floats a row.
// Per 4 values of c: 8 float4 loads, 64 FMAs. Groups j >= nj (columns
// past the ragged end of a tile) are skipped unless FULL.
template <int HD, bool FULL>
__device__ __forceinline__ void mt_dot(float (&acc)[4][4], const float* a,
                                       const float* b, int stride, int nj) {
  // unrolled by 4 steps, not HD / 4: on an H100 the whole-loop unroll was
  // 5% slower at the ViT-B/16 shape and 27% at batch 1, with four times
  // the code (tools/kernel_variants.py, PERF.md)
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld_f32<4>(av[i], a + i * stride + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (FULL || j < nj) ld_f32<4>(bv[j], b + 16 * j * stride + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (FULL || j < nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
  }
}

// acc[i][n] += sum_k w[i][k] x[k][n] over k < nk (a multiple of 16; 64 if
// FULL): w the thread's 4 rows of a [rows][F32_TILE] tile (row stride
// F32_PS), x its TN columns of a [F32_TILE][HD] tile (row stride HD + 4).
// Per 4 values of k: 4 + 4 loads, 16 TN FMAs.
template <int HD, bool FULL>
__device__ __forceinline__ void mt_acc(float (&acc)[4][HD / 16],
                                       const float* w, const float* x,
                                       int nk) {
  constexpr int TN = HD / 16;
  auto four = [&](int k) {
    float wv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld_f32<4>(wv[i], w + i * F32_PS + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float xv[TN];
      ld_f32<TN>(xv, x + (k + kk) * (HD + 4));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[i][n] = fmaf(wv[i][kk], xv[n], acc[i][n]);
    }
  };
  if constexpr (FULL) {
#pragma unroll 4
    for (int k = 0; k < F32_TILE; k += 4) four(k);
  } else {
#pragma unroll 4
    for (int k = 0; k < nk; k += 4) four(k);
  }
}

// The 16 mask values of a thread's 4 rows x 4 columns (col0 + 16 j) of a
// score tile, straight from L2: 16 loads against a tile's 2-4 products of
// 4 x 4 x HD FMAs a thread, issued before them so that they are in flight
// while those run; staging them would cost the shared memory of a third
// ring operand. Entries past L read as 0. TRANSPOSED: the rows are keys
// and the columns queries (K2's dk/dv kernel).
template <bool TRANSPOSED>
__device__ __forceinline__ void load_mask_f32(float (&mk)[4][4],
                                              const float* mask, int L,
                                              int row0, int col0) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + r, col = col0 + 16 * j;
      const long long at = TRANSPOSED ? (long long)col * L + row
                                      : (long long)row * L + col;
      mk[r][j] = row < L && col < L ? __ldg(mask + at) : 0.f;
    }
}

// The max (SUM false) or sum over the 16 lanes of a half warp.
template <bool SUM>
__device__ __forceinline__ float half_warp_reduce(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = SUM ? v + w : fmaxf(v, w);
  }
  return v;
}

// cp.async copy of rows [row0, row0 + ROWS) x [0, HD) of a strided fp32
// slice into a ROWS x HD tile in shared memory, row stride HD + 4; rows
// at or past `rows` are zero-filled. Every thread of the block issues its
// share of the 16-byte copies; the caller commits.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int rows, int threads) {
  constexpr int CHUNKS = ROWS * HD / 4;
  for (int i = threadIdx.x; i < CHUNKS; i += threads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * (HD + 4) + c, ok ? src + row * stride + c : src,
               ok);
  }
}

// Rows an fp32 block covers (16, 32 or 64): `rows`, halved while the
// grid (row chunks x heads x batch) would leave SMs idle.
inline int f32_fill_rows(int rows, int L, long long heads_x_batch, int sms) {
  while (rows > 16 && (L + rows - 1) / rows * heads_x_batch < sms) rows /= 2;
  return rows;
}

// The most rows a block may cover (16, 32 or 64) whose padding past L (a
// ragged last chunk computes its padded rows) stays within waste_pct
// percent of L.
inline int f32_pad_rows(int L, int waste_pct) {
  int rows = 64;
  while (rows > 16 && (long long)(L + rows - 1) / rows * rows * 100 >
                          (100LL + waste_pct) * L)
    rows /= 2;
  return rows;
}

}  // namespace attn_tile
