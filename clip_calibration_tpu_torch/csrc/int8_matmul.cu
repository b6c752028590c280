// Exact int8 x int8 -> int32 matrix product (K3).
//
// Replaces the TPU kernel clip_calibration_tpu/ops/pallas_int8_matmul.py::
// _matmul_kernel (reached through int8_matmul's pl.pallas_call). Same
// function: out[M, N] = x[M, K] @ w[K, N], x and w int8 row-major, out
// int32 row-major, exact (integer sums; |sum| <= K * 128^2 < 2^31 for
// K < 131072). The w8a8 serving path (ops/quant.py::qdot) quantizes the
// activations to int8 before it and rescales acc * x_scale * w_scale in
// fp32 after it, outside the kernel, as the JAX code does.
//
// What bounds it on an H100 SXM: bytes, at every serving shape, and the
// int32 output is most of them. ViT-B/16 at batch 64, the wqkv product
// (M = 64 * 208 = 13312, K = 768, N = 2304): 2*M*N*K = 47.1 G int8
// operations, 23.8 us at the 1,979 TOP/s int8 tensor-core peak, against
// x 10.2 MB + w 1.8 MB + out 122.7 MB = 134.7 MB moved, 40.2 us at
// 3.35 TB/s. What the design does about it: every output element is
// written once, straight from the registers that accumulated it, and
// nothing else goes back to device memory; x and w are read in tiles that
// neighbouring blocks share through L2. The real cure is fewer output
// bytes: a fused rescale-and-bias epilogue writing bf16 (a later PR).
//
// Unlike the TPU kernel, whose grid walks K sequentially and carries a
// VMEM-resident int32 accumulator across grid steps, a block here owns one
// 128 x 128 output tile and loops over K itself (blocks run in parallel in
// no order, so nothing may carry across them); the sum stays in registers.
// 8 warps, 2 (M) x 4 (N), each 64 x 32 of the tile, on the int8 tensor
// cores through mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. Per K
// tile of 64, x's [128, 64] and w's [64, 128] tiles are staged in shared
// memory; the next K tile's loads are issued into registers before the
// current tile's products, so they overlap (no cp.async/TMA/wgmma yet).
//
// The weight stays [K, N] (N contiguous), the layout of every public
// function and file. The mma's .col B operand wants 4 consecutive k of one
// column in each 32-bit register, and ldmatrix.trans only transposes
// 16-bit elements, so the tile is transposed by hand on its way into
// shared memory: each thread reads 8 columns of 4 consecutive K rows
// (four 8-byte loads) and byte-permutes them into 8 words of 4 k each,
// stored as w^T [n][k]. Both shared tiles use an 80-byte row (64 data +
// 16 pad), which makes every fragment read conflict-free.
//
// Ragged shapes: rows past M, columns past N and k past K are loaded as
// zeros (they add nothing to the sums) and never stored; when K or N do
// not allow the 16- and 8-byte vector loads, loads go byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int ROW = BK + 16;     // shared row, bytes: 20 words

// one thread's share of a K tile, held in registers between the global
// loads and the shared-memory stores: two 16-byte chunks of x, and four
// 8-byte rows (k .. k+3) of w at 8 consecutive columns
struct Tile {
  uint4 a[2];
  uint2 b[4];
};

__device__ __forceinline__ uint32_t load4_bytes(const int8_t* p, int valid) {
  // the first `valid` (0..4) bytes at p, zero-padded, little-endian
  uint32_t v = 0;
  for (int j = 0; j < 4; ++j)
    if (j < valid) v |= uint32_t(uint8_t(p[j])) << (8 * j);
  return v;
}

__device__ __forceinline__ void load_tile(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
    int N, int K, int m0, int n0, int k0, bool vec_a, bool vec_b, Tile& t) {
  const int tid = threadIdx.x;
  // x: 128 rows x 64 bytes = 512 chunks of 16 bytes, two per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int gm = m0 + c / 4;
    const int gk = k0 + (c % 4) * 16;
    if (vec_a && gm < M && gk < K) {
      t.a[i] = *reinterpret_cast<const uint4*>(x + size_t(gm) * K + gk);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const int8_t* p = x + size_t(gm) * K + gk;
        for (int j = 0; j < 4; ++j) {
          const int valid = min(max(K - gk - 4 * j, 0), 4);
          if (valid > 0) v[j] = load4_bytes(p + 4 * j, valid);
        }
      }
      t.a[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  // w: 64 rows x 128 bytes; thread = (4-row group kg, 8-column chunk nc),
  // kg fastest, so a warp's shared-memory stores below spread over banks
  const int kg = tid % 16, nc = tid / 16;
  const int gn = n0 + nc * 8;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gk = k0 + kg * 4 + r;
    if (vec_b && gk < K && gn < N) {
      t.b[r] = *reinterpret_cast<const uint2*>(w + size_t(gk) * N + gn);
    } else {
      uint32_t lo = 0, hi = 0;
      if (gk < K) {
        const int8_t* p = w + size_t(gk) * N + gn;
        lo = load4_bytes(p, min(max(N - gn, 0), 4));
        hi = load4_bytes(p + 4, min(max(N - gn - 4, 0), 4));
      }
      t.b[r] = make_uint2(lo, hi);
    }
  }
}

// 4 words (rows k..k+3, 4 columns each) -> 4 words (columns, 4 k each):
// out[j] byte r = in[r] byte j
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t out[4]) {
  const uint32_t t01 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t23 = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
  const uint32_t u01 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t u23 = __byte_perm(r2, r3, 0x7362);  // r2.2 r3.2 r2.3 r3.3
  out[0] = __byte_perm(t01, t23, 0x5410);            // r0.0 r1.0 r2.0 r3.0
  out[1] = __byte_perm(t01, t23, 0x7632);            // r0.1 r1.1 r2.1 r3.1
  out[2] = __byte_perm(u01, u23, 0x5410);            // r0.2 r1.2 r2.2 r3.2
  out[3] = __byte_perm(u01, u23, 0x7632);            // r0.3 r1.3 r2.3 r3.3
}

__device__ __forceinline__ void store_tile(int8_t* sa, int8_t* sb,
                                           const Tile& t) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    *reinterpret_cast<uint4*>(sa + (c / 4) * ROW + (c % 4) * 16) = t.a[i];
  }
  const int kg = tid % 16, nc = tid / 16;
  uint32_t lo[4], hi[4];
  transpose4x4(t.b[0].x, t.b[1].x, t.b[2].x, t.b[3].x, lo);
  transpose4x4(t.b[0].y, t.b[1].y, t.b[2].y, t.b[3].y, hi);
  int8_t* dst = sb + (nc * 8) * ROW + kg * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(dst + j * ROW) = lo[j];
    *reinterpret_cast<uint32_t*>(dst + (j + 4) * ROW) = hi[j];
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w, int32_t* __restrict__ out,
                   int M, int N, int K, bool vec_a, bool vec_b,
                   bool vec_out) {
  __shared__ __align__(16) int8_t sa[BM * ROW];
  __shared__ __align__(16) int8_t sb[BN * ROW];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int g = lane / 4, tq = lane % 4;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  Tile t;
  const int n_k = (K + BK - 1) / BK;
  load_tile(x, w, M, N, K, m0, n0, 0, vec_a, vec_b, t);
  store_tile(sa, sb, t);
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k)
      load_tile(x, w, M, N, K, m0, n0, (kt + 1) * BK, vec_a, vec_b, t);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = sa + (wm + mi * 16 + g) * ROW + ks + tq * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = sb + (wn + ni * 8 + g) * ROW + ks + tq * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
    if (kt + 1 < n_k) {
      store_tile(sa, sb, t);
      __syncthreads();
    }
  }

  // accumulator fragment: c0, c1 at (row g, cols 2tq, 2tq+1), c2, c3 at
  // row g + 8
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tq * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
        int32_t* o = out + size_t(row) * N + col;
        const int c0 = acc[mi][ni][2 * h], c1 = acc[mi][ni][2 * h + 1];
        if (vec_out && col + 1 < N) {
          *reinterpret_cast<int2*>(o) = make_int2(c0, c1);
        } else {
          if (col < N) o[0] = c0;
          if (col + 1 < N) o[1] = c1;
        }
      }
    }
  }
}

}  // namespace

// out [M, N] int32 = x [M, K] int8 @ w [K, N] int8, all row-major and
// contiguous, on `stream`. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the grid cannot cover).
extern "C" int int8_matmul(const void* x, const void* w, void* out, int M,
                           int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535 || K >= 131072)
    return cudaErrorInvalidValue;
  const bool vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  const bool vec_out =
      N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K, vec_a, vec_b, vec_out);
  return cudaGetLastError();
}
