// Exact int8 x int8 -> int32 matrix product (K3), with the w8a8 rescale
// as an optional epilogue.
//
// Replaces the TPU kernel clip_calibration_tpu/ops/pallas_int8_matmul.py::
// _matmul_kernel (reached through int8_matmul's pl.pallas_call). Same
// function: out[M, N] = x[M, K] @ w[K, N], int8 in, int32 out, exact
// (integer sums; |sum| <= K * 128^2 < 2^31 for K < 131072). The rescaled
// entry point then computes, per element and in this order, the JAX
// w8a8_matmul epilogue that XLA fuses behind the TPU kernel:
//     out = dtype(float(acc) * x_scale[row] * w_scale[col])
// (fp32 products, each rounded to nearest; one rounding to bf16 or fp32;
// x_scale per row or one static scale), so the int32 tile never reaches
// device memory.
//
// What bounds it on an H100 SXM: bytes, at every serving shape, and the
// output is most of them. The 32-row serving bucket's w_fc (M = 32 * 208 =
// 6656, K = 768, N = 3072): 2 M N K = 31.4 G int8 operations, 15.9 us at
// the 1,979 TOP/s int8 tensor-core peak, against x 5.1 MB + w 2.4 MB +
// int32 out 81.8 MB = 89.3 MB, 26.6 us at 3.35 TB/s; rescaled to bf16 the
// output is 40.9 MB and the bound 14.5 us. What the design does about it:
// - The output tile is staged in shared memory and leaves in 16-byte
//   streaming stores (evict-first in L2), one 512-byte int32 row per warp
//   instruction, and two blocks share an SM, so one block's stores run
//   under the other's products. (Stores straight from the accumulator
//   registers, and persistent blocks whose k-tile stream runs across
//   output tiles, were both slower on the H100: PERF.md.)
// - The rescaled epilogue writes the caller's dtype (bf16: half the int32
//   bytes) and removes the three elementwise passes over the int32 tensor
//   that the rescale took as separate PyTorch operations.
// - The weight arrives K-major ([N, K], ops/quant.py keeps that copy beside
//   the [K, N] weight), the layout the int8 wgmma reads for B: no
//   transposition in the kernel.
//
// Unlike the TPU kernel, whose grid walks K in order with a VMEM-resident
// int32 accumulator, a block owns a 128 x 128 output tile and loops over
// K itself. Two warpgroups of 4 warps each own 64 rows and
// issue wgmma.mma_async m64n128k32 s8 (Hopper's warpgroup tensor-core
// product; int8 wgmma reads both operands K-major from shared memory). K
// arrives in 128-byte tiles (one 128-byte swizzled row per M or N index,
// the layout the wgmma descriptor names) through a three-stage cp.async
// ring: 16-byte copies written at chunk c ^ (row % 8) of their row, one
// barrier a tile, the copies of tile i + 2 in flight while the products of
// tile i run.
//
// Small grids: when the output tiles leave SMs idle (the 1-row serving
// bucket, M = 208: 12 to 48 tiles on 132 SMs), the launcher splits K
// across `split` blocks per tile that add their partial tiles into a
// zeroed int32 output with atomicAdd: integer addition is exact and
// order-independent, so the result stays bit-exact. A split rescaled
// product then takes one small elementwise kernel for its epilogue.
//
// Ragged shapes: rows past M and columns past N are zero-filled on load
// (cp.async with no source bytes) and never stored. K must be a multiple
// of 16 and x and w 16-byte aligned (the 16-byte copies); the wrapper
// zero-pads K otherwise (zeros add nothing).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

// a block tile is 128 x 128 so that two blocks share an SM and one's
// stores overlap the other's products (128 x 256 tiles, one block an SM,
// were slower at every measured shape: PERF.md)
constexpr int BM = 128;       // rows of a block tile: two warpgroups of 64
constexpr int BN = 128;       // columns of a block tile
constexpr int BK = 128;       // k of a ring stage, bytes: one swizzled row
constexpr int STAGES = 3;     // ring depth: tile i + 2 copies while i runs
constexpr int THREADS = 256;  // two warpgroups
constexpr int SMS = 132;

// epilogues
constexpr int EPI_INT32 = 0;   // int32 out, stored
constexpr int EPI_ATOMIC = 1;  // int32 out, added (a split of K)
constexpr int EPI_F32 = 2;     // rescaled, fp32 out
constexpr int EPI_BF16 = 3;    // rescaled, bf16 out

constexpr int STAGE = (BM + BN) * BK;  // bytes: A then B
constexpr int RING = STAGES * STAGE;
constexpr int OUT_LD = BN + 8;  // int32 per staged output row
constexpr int OUT_BYTES = BM * OUT_LD * 4;
// + 1 KB: the swizzle atoms start at a 1024-byte boundary
constexpr int SMEM = (RING > OUT_BYTES ? RING : OUT_BYTES) + 1024;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows: start address, leading offset (unused by this layout: 1), stride
// offset 1024 bytes (8 rows), swizzle mode 1 (128 bytes)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= A [64 x 32] B [128 x 32]^T, s8 in, s32 sums: A and B K-major in
// 128-byte swizzled shared rows (descriptors da, db); d is added to
// unless scale_d is 0
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// rows [row0, row0 + ROWS) x k bytes [k0, k0 + BK) of a K-major int8
// matrix (row stride K bytes) into 128-byte swizzled rows at dst: 16-byte
// chunk c of row r at r * 128 + (c ^ (r % 8)) * 16. Rows at or past
// `rows` and k at or past K are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const int8_t* src, int rows, int K,
                                          int row0, int k0) {
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / 8, c = i % 8, row = row0 + r, k = k0 + c * 16;
    const bool ok = row < rows && k < K;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? src + (long long)row * K + k : src, ok);
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ wt, void* __restrict__ out,
                       const float* __restrict__ xs, int xs_per_row,
                       const float* __restrict__ ws, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // warpgroup: rows 64 wg .. 64 wg + 63
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this block's k tiles: split z of gridDim.z
  const int nk_all = (K + BK - 1) / BK;
  const int kt0 = (int)((long long)blockIdx.z * nk_all / gridDim.z);
  const int nk = (int)((long long)(blockIdx.z + 1) * nk_all / gridDim.z) - kt0;

  auto issue = [&](int i) {  // k tile kt0 + i into stage i % STAGES
    unsigned char* st = smem + (i % STAGES) * STAGE;
    const int k0 = (kt0 + i) * BK;
    load_rows<BM>(st, x, M, K, m0, k0);
    load_rows<BN>(st + BM * BK, wt, N, K, n0, k0);
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    fence_proxy_async();          // ... visible to the wgmma (async proxy)
    __syncthreads();  // everyone's; and tile i - 1's products are done
    if (i + STAGES - 1 < nk) issue(i + STAGES - 1);  // into i - 1's stage
    cp_async_commit();
    const unsigned char* st = smem + (i % STAGES) * STAGE;
    const uint64_t da = smem_desc(st + wg * 64 * BK);
    const uint64_t db = smem_desc(st + BM * BK);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes: descriptor + 2
      wgmma_n128(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile over it

  // accumulator fragment of warp w (its 16 rows of the warpgroup's 64),
  // lane (g, t) = (lane / 4, lane % 4): acc[4 j + 2 h + e] at row
  // 16 (w % 4) + g + 8 h, column 8 j + 2 t + e
  int32_t* so = reinterpret_cast<int32_t*>(smem);
  {
    const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<int2*>(so + row * OUT_LD + 8 * j + col) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(so + (row + 8) * OUT_LD + 8 * j + col) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  if constexpr (EPI == EPI_ATOMIC) {
    // one int32 a lane, 32 consecutive columns a warp instruction
    int32_t* o = static_cast<int32_t*>(out);
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
      if (row < M && col < N)
        atomicAdd(o + (long long)row * N + col, so[r * OUT_LD + c]);
    }
    return;
  }
  // 4 columns a lane: a warp stores 128 consecutive columns of one row,
  // streaming (evict-first in L2, so the output does not push the
  // operands, which every block of a row or column reads again, out of it)
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int c = lane * 4; c < BN; c += 128) {
    const int col = n0 + c;
    if (col >= N) break;
    const bool full = vec && col + 3 < N;
    float w[4] = {0.f, 0.f, 0.f, 0.f};  // this lane's column scales
    if constexpr (EPI == EPI_F32 || EPI == EPI_BF16) {
      if (full) {
        const float4 w4 = *reinterpret_cast<const float4*>(ws + col);
        w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
      } else {
        for (int e = 0; e < 4 && col + e < N; ++e) w[e] = ws[col + e];
      }
    }
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      if (row >= M) break;
      const int4 v = *reinterpret_cast<const int4*>(so + r * OUT_LD + c);
      const long long at = (long long)row * N + col;
      const int vv[4] = {v.x, v.y, v.z, v.w};
      if constexpr (EPI == EPI_INT32) {
        int32_t* o = static_cast<int32_t*>(out) + at;
        if (full) {
          __stcs(reinterpret_cast<int4*>(o), v);
        } else {
          for (int e = 0; e < 4 && col + e < N; ++e) o[e] = vv[e];
        }
      } else {
        // float(acc) * xs * ws in fp32, each product rounded (no FMA)
        const float xsr = xs[xs_per_row ? row : 0];
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = __fmul_rn(__fmul_rn(__int2float_rn(vv[e]), xsr), w[e]);
        if constexpr (EPI == EPI_F32) {
          float* o = static_cast<float*>(out) + at;
          if (full)
            __stcs(reinterpret_cast<float4*>(o),
                   make_float4(f[0], f[1], f[2], f[3]));
          else
            for (int e = 0; e < 4 && col + e < N; ++e) o[e] = f[e];
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
          if (full) {
            __stcs(reinterpret_cast<uint2*>(o),
                   make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3])));
          } else {
            for (int e = 0; e < 4 && col + e < N; ++e)
              o[e] = __float2bfloat16_rn(f[e]);
          }
        }
      }
    }
  }
}

// the rescale of an int32 product (after a split of K): the rescaled
// epilogue above, elementwise, 4 columns a thread
template <bool BF16>
__global__ void __launch_bounds__(256)
    int8_rescale_kernel(const int32_t* __restrict__ acc,
                        const float* __restrict__ xs, int xs_per_row,
                        const float* __restrict__ ws, void* __restrict__ out,
                        int M, int N) {
  const int per_row = (N + 3) / 4;
  const long long n = (long long)M * per_row;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const int row = (int)(i / per_row), col = (int)(i % per_row) * 4;
    const float xsr = xs[xs_per_row ? row : 0];
    const long long at = (long long)row * N + col;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = col + e < N ? __fmul_rn(__fmul_rn(__int2float_rn(acc[at + e]),
                                               xsr), ws[col + e])
                         : 0.f;
    for (int e = 0; e < 4 && col + e < N; ++e) {
      if constexpr (BF16)
        static_cast<__nv_bfloat16*>(out)[at + e] = __float2bfloat16_rn(f[e]);
      else
        static_cast<float*>(out)[at + e] = f[e];
    }
  }
}

template <int EPI>
cudaError_t launch(const void* x, const void* wt, void* out, const float* xs,
                   int xs_per_row, const float* ws, int M, int N, int K,
                   int split, cudaStream_t stream) {
  static size_t allowed = 0;
  auto kernel = int8_matmul_kernel<EPI>;
  const cudaError_t err = allow_smem(kernel, SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), out, xs,
      xs_per_row, ws, M, N, K);
  return cudaGetLastError();
}

// blocks one output tile's K is split across: 1 while the tiles alone
// fill the SMs; else as many as fill them, at most one per k tile (the
// 1-row serving bucket, M 208: 12 to 48 tiles)
int split_of(int M, int N, int K) {
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles >= SMS) return 1;
  const int fill = (int)((SMS + tiles - 1) / tiles), nk = (K + BK - 1) / BK;
  return fill < nk ? fill : nk;
}

// the split product: `split` blocks a tile add into the zeroed int32 acc
cudaError_t launch_split(const void* x, const void* wt, int32_t* acc, int M,
                         int N, int K, int split, cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  return launch<EPI_ATOMIC>(x, wt, acc, nullptr, 0, nullptr, M, N, K, split,
                            stream);
}

cudaError_t launch_rescale(const int32_t* acc, const float* xs,
                           int xs_per_row, const float* ws, void* out,
                           bool bf16, int M, int N, cudaStream_t stream) {
  const long long want = ((long long)M * ((N + 3) / 4) + 255) / 256;
  const int blocks = (int)(want < 4 * SMS ? want : 4 * SMS);
  if (bf16)
    int8_rescale_kernel<true><<<blocks, 256, 0, stream>>>(acc, xs, xs_per_row,
                                                          ws, out, M, N);
  else
    int8_rescale_kernel<false><<<blocks, 256, 0, stream>>>(
        acc, xs, xs_per_row, ws, out, M, N);
  return cudaGetLastError();
}

bool bad_shape(const void* x, const void* wt, int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || K % 16 != 0 || K >= 131072 ||
         (M + BM - 1) / BM > 65535 ||
         reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(wt) % 16 != 0;
}

}  // namespace

// The split of K the launcher takes for an [M, K] x [K, N] product (K a
// multiple of 16): 1, or the blocks per output tile that add into an
// int32 product; a rescaled product that splits needs int32 scratch.
extern "C" int int8_matmul_split(int M, int N, int K) {
  return split_of(M, N, K);
}

// out [M, N] int32 = x [M, K] int8 @ wt [N, K]^T (wt: the weight K-major),
// all row-major and contiguous, x and wt 16-byte aligned, K a multiple of
// 16, on `stream` (a split of K zeroes `out` first). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes
// the kernel does not take).
extern "C" int int8_matmul(const void* x, const void* wt, void* out, int M,
                           int N, int K, void* stream) {
  if (bad_shape(x, wt, M, N, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split = split_of(M, N, K);
  if (split > 1)
    return launch_split(x, wt, static_cast<int32_t*>(out), M, N, K, split, s);
  return launch<EPI_INT32>(x, wt, out, nullptr, 0, nullptr, M, N, K, 1, s);
}

// out [M, N] = dtype(float(x @ wt^T) * xs * ws), dtype 0: float32, 1:
// bfloat16; xs float32, [M] when xs_per_row, else one value; ws float32
// [N]; the same shape rules as int8_matmul. Where K is split
// (int8_matmul_split > 1), the int32 product goes to `acc` (int32 [M, N]
// scratch; may be null otherwise) and one elementwise kernel rescales it.
extern "C" int int8_matmul_rescaled(const void* x, const void* wt,
                                    const void* xs, int xs_per_row,
                                    const void* ws, void* out, int dtype,
                                    void* acc, int M, int N, int K,
                                    void* stream) {
  if (bad_shape(x, wt, M, N, K) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  const int split = split_of(M, N, K);
  if (split > 1) {
    if (acc == nullptr) return cudaErrorInvalidValue;
    int32_t* a = static_cast<int32_t*>(acc);
    const cudaError_t err = launch_split(x, wt, a, M, N, K, split, s);
    if (err != cudaSuccess) return err;
    return launch_rescale(a, xsf, xs_per_row, wsf, out, dtype == 1, M, N, s);
  }
  if (dtype == 1)
    return launch<EPI_BF16>(x, wt, out, xsf, xs_per_row, wsf, M, N, K, 1, s);
  return launch<EPI_F32>(x, wt, out, xsf, xs_per_row, wsf, M, N, K, 1, s);
}
