// Tile code shared by the port's attention kernels (K1 csrc/mha_qkv_fwd.cu,
// K2 csrc/mha_qkv_bwd.cu, K4 csrc/int8_attention.cu) and K3
// (csrc/int8_matmul.cu): the mma.sync wrappers, fragment loads, and
// cp.async copies that fill the two-stage tile rings the redesigned K1
// and K4 stream keys through.
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K3's form: the B fragment as one pair
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  mma_s8(c, a, b[0], b[1]);
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

// cp.async copy of rows [row0, row0 + ROWS) x [0, HD) of a strided bf16
// slice into a ROWS x HD tile in shared memory, row stride HD + 8 (so
// ldmatrix and the fragment reads are free of bank conflicts). Rows at or
// past `rows` are zero-filled. Every thread of the block issues its share;
// the caller commits. The kernels keep two such tiles per operand, a ring:
// the copy of key tile j + 1 is in flight while the warps compute tile j.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows, int threads) {
  constexpr int CHUNKS = ROWS * HD / 8;
  for (int i = threadIdx.x; i < CHUNKS; i += threads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8, row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * (HD + 8) + c, ok ? src + row * stride + c : src, ok);
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

}  // namespace attn_tile
