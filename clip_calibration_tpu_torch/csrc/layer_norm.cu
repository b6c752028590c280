// LayerNorm over the last dimension, forward and backward, with fp32
// statistics whatever the input dtype (bf16 or fp32 in and out).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// LayerNorm (clip_calibration_tpu/ops/attention.py::layer_norm) into one
// pass on its own. In PyTorch the same function ran as ten separate
// operations (a cast to fp32, mean, var, the subtraction, + eps, rsqrt, the
// broadcast products and adds, the cast back), each a full pass over device
// memory, about 52 bytes an element, and its autograd saved two fp32 copies
// of the row for a backward of about ten more passes. Same function:
//     y = dtype((x - mean) * rsqrt(var + eps) * gamma + beta)
// with mean and the biased var of each row in fp32, gamma and beta fp32.
// The backward, from the saved x, mean and rstd = rsqrt(var + eps):
//     dx = dtype(rstd * (g' - mean(g') - xh * mean(g' * xh))),
//     g' = g * gamma, xh = (x - mean) * rstd,
// all in fp32; dx is rounded once to x's dtype, where the decomposition's
// cast back (ToCopyBackward) rounded it.
//
// What bounds it on an H100 SXM: bytes. The forward reads x and writes y,
// 4 bytes an element in bf16 (plus 8 bytes a row of mean and rstd); the
// backward reads x and g and writes dx, 6. bigG's vision rows [8704, 1664]
// bf16: 58.0 MB, 17.3 us at 3.35 TB/s, against ~10 operations an element,
// 0.14 GFLOP, far under the card's ridge point. What the design does about
// it:
// - Each element is read once and written once. A row lives in registers:
//   a group of TPR lanes of one warp owns a row, each lane holding VPL
//   vectors of 8 elements (one 16-byte load in bf16, two in fp32), lane t
//   vectors t, t + TPR, ...: neighbouring lanes read neighbouring 16-byte
//   chunks. At width 1664 that is 32 lanes of 7 (or 6) vectors, 56 fp32
//   registers of x a lane.
// - The mean, then the variance as the mean of (x - mean)^2, in two
//   passes over the registers (no E[x^2] - E[x]^2 cancellation), each
//   summed across the group with warp shuffles; no shared memory, no
//   barrier.
// - TPR and VPL follow the width, which the launcher sees: widths up to
//   128 give each row the smallest power of two of lanes that covers its
//   vectors (one vector a lane; 8 lanes at width 64), wider rows a whole
//   warp with VPL = ceil(width / 256), to 8 (width 2048). Blocks of 128
//   threads hold 128 / TPR rows.
// - The backward keeps x and g of a row in registers (2 x VPL x 8 fp32
//   values a lane: 112 at width 1664) and needs two group sums.
// The scale and shift (gamma, beta; fp32, read from L2 by every row) are
// applied in fp32 before the one rounding to the output dtype.
//
// x, y, g and dx are contiguous [rows, D], 16-byte aligned; the width D
// must be a multiple of 8 (one vector). The wrapper (ops/layer_norm.py)
// makes strided views contiguous first: ln_post's x[:, 0] (32 rows of
// [B, L, D] a tower call) and ln_final's unpadded x[:, :L] are copied,
// which costs less than a row-stride argument in both kernels.
// A group whose row is past the last still runs the shuffles (full-warp
// masks), reading and writing nothing.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 8;        // elements a vector
constexpr int BLOCK = 128;    // threads a block
constexpr int MAX_VPL = 8;    // vectors a lane at most: width 32 x 8 x 8

template <int N>
using Int = std::integral_constant<int, N>;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the sum over the TPR lanes of a row (aligned groups inside one warp)
template <int TPR>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int TPR, int VPL>
__device__ __forceinline__ void fwd_row(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
    int D, float eps) {
  const int lane = threadIdx.x % TPR;
  const long long row =
      (long long)blockIdx.x * (BLOCK / TPR) + threadIdx.x / TPR;
  const bool live = row < rows;
  const int C = D / VEC;
  const T* xr = x + row * D;
  float v[VPL][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + k * TPR;
    if (live && c < C) {
      load8(xr + c * VEC, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += v[k][i];
  }
  const float mean = group_sum<TPR>(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + k * TPR < C) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[k][i] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(group_sum<TPR>(q) / D + eps);
  if (!live) return;
  T* yr = y + row * D;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + k * TPR;
    if (c < C) {
      float g[VEC], b[VEC];
      load8(gamma + c * VEC, g);
      load8(beta + c * VEC, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        v[k][i] = (v[k][i] - mean) * rstd * g[i] + b[i];
      store8(yr + c * VEC, v[k]);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int TPR, int VPL>
__device__ __forceinline__ void bwd_row(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ gamma, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, T* __restrict__ dx, int rows, int D) {
  const int lane = threadIdx.x % TPR;
  const long long row =
      (long long)blockIdx.x * (BLOCK / TPR) + threadIdx.x / TPR;
  const bool live = row < rows;
  const int C = D / VEC;
  const float mean = live ? mean_in[row] : 0.f;
  const float rstd = live ? rstd_in[row] : 0.f;
  const T* xr = x + row * D;
  const T* gr = g + row * D;
  float xh[VPL][VEC], gh[VPL][VEC];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + k * TPR;
    if (live && c < C) {
      float w[VEC];
      load8(xr + c * VEC, xh[k]);
      load8(gr + c * VEC, gh[k]);
      load8(gamma + c * VEC, w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        xh[k][i] = (xh[k][i] - mean) * rstd;
        gh[k][i] *= w[i];
        s1 += gh[k][i];
        s2 += gh[k][i] * xh[k][i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xh[k][i] = gh[k][i] = 0.f;
    }
  }
  const float a = group_sum<TPR>(s1) / D;
  const float b = group_sum<TPR>(s2) / D;
  if (!live) return;
  T* dr = dx + row * D;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = lane + k * TPR;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        gh[k][i] = rstd * (gh[k][i] - a - xh[k][i] * b);
      store8(dr + c * VEC, gh[k]);
    }
  }
}

// one kernel name per dtype, so that ptxas's report names each instance
// (ops/build.py::_kernel_name)
template <int TPR, int VPL>
__global__ void __launch_bounds__(BLOCK) layer_norm_fwd_bf16(
    const __nv_bfloat16* x, const float* gamma, const float* beta,
    __nv_bfloat16* y, float* mean, float* rstd, int rows, int D, float eps) {
  fwd_row<__nv_bfloat16, TPR, VPL>(x, gamma, beta, y, mean, rstd, rows, D,
                                   eps);
}

template <int TPR, int VPL>
__global__ void __launch_bounds__(BLOCK) layer_norm_fwd_f32(
    const float* x, const float* gamma, const float* beta, float* y,
    float* mean, float* rstd, int rows, int D, float eps) {
  fwd_row<float, TPR, VPL>(x, gamma, beta, y, mean, rstd, rows, D, eps);
}

template <int TPR, int VPL>
__global__ void __launch_bounds__(BLOCK) layer_norm_bwd_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, const float* gamma,
    const float* mean, const float* rstd, __nv_bfloat16* dx, int rows,
    int D) {
  bwd_row<__nv_bfloat16, TPR, VPL>(x, g, gamma, mean, rstd, dx, rows, D);
}

template <int TPR, int VPL>
__global__ void __launch_bounds__(BLOCK) layer_norm_bwd_f32(
    const float* x, const float* g, const float* gamma, const float* mean,
    const float* rstd, float* dx, int rows, int D) {
  bwd_row<float, TPR, VPL>(x, g, gamma, mean, rstd, dx, rows, D);
}

// calls f(Int<TPR>, Int<VPL>) with the layout of a row of C vectors
template <typename F>
cudaError_t with_layout(int C, F f) {
  if (C <= 1) return f(Int<1>{}, Int<1>{});
  if (C <= 2) return f(Int<2>{}, Int<1>{});
  if (C <= 4) return f(Int<4>{}, Int<1>{});
  if (C <= 8) return f(Int<8>{}, Int<1>{});
  if (C <= 16) return f(Int<16>{}, Int<1>{});
  switch ((C + 31) / 32) {
    case 1: return f(Int<32>{}, Int<1>{});
    case 2: return f(Int<32>{}, Int<2>{});
    case 3: return f(Int<32>{}, Int<3>{});
    case 4: return f(Int<32>{}, Int<4>{});
    case 5: return f(Int<32>{}, Int<5>{});
    case 6: return f(Int<32>{}, Int<6>{});
    case 7: return f(Int<32>{}, Int<7>{});
    case 8: return f(Int<32>{}, Int<8>{});
    default: return cudaErrorInvalidValue;
  }
}

bool bad_args(const void* x, int rows, int D, int dtype) {
  return rows < 1 || D < VEC || D % VEC != 0 || D > 32 * MAX_VPL * VEC ||
         (dtype != 0 && dtype != 1) ||
         reinterpret_cast<uintptr_t>(x) % 16 != 0;
}

}  // namespace

// y [rows, D] = LayerNorm of the rows of x [rows, D], gamma and beta
// float32 [D]; mean and rstd float32 [rows] out. dtype 0: float32, 1:
// bfloat16 (x and y). D a multiple of 8 up to 2048
// (ops/layer_norm.py::MAX_WIDTH); x, y, gamma and beta contiguous and
// 16-byte aligned; on the current device, on `stream`. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int layer_norm_fwd(const void* x, const void* gamma,
                              const void* beta, void* y, void* mean,
                              void* rstd, int rows, int D, float eps,
                              int dtype, void* stream) {
  if (bad_args(x, rows, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(gamma);
  const float* bf = static_cast<const float*>(beta);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  return with_layout(D / VEC, [&](auto tpr, auto vpl) {
    constexpr int TPR = decltype(tpr)::value, VPL = decltype(vpl)::value;
    const int grid = (rows + BLOCK / TPR - 1) / (BLOCK / TPR);
    if (dtype == 1)
      layer_norm_fwd_bf16<TPR, VPL><<<grid, BLOCK, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), gf, bf,
          static_cast<__nv_bfloat16*>(y), mf, rf, rows, D, eps);
    else
      layer_norm_fwd_f32<TPR, VPL><<<grid, BLOCK, 0, s>>>(
          static_cast<const float*>(x), gf, bf, static_cast<float*>(y), mf,
          rf, rows, D, eps);
    return cudaGetLastError();
  });
}

// dx [rows, D] of x's dtype from x and g [rows, D] (x's dtype), gamma
// float32 [D] and the forward's mean and rstd float32 [rows]; the same
// argument rules as layer_norm_fwd.
extern "C" int layer_norm_bwd(const void* x, const void* g,
                              const void* gamma, const void* mean,
                              const void* rstd, void* dx, int rows, int D,
                              int dtype, void* stream) {
  if (bad_args(x, rows, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(gamma);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  return with_layout(D / VEC, [&](auto tpr, auto vpl) {
    constexpr int TPR = decltype(tpr)::value, VPL = decltype(vpl)::value;
    const int grid = (rows + BLOCK / TPR - 1) / (BLOCK / TPR);
    if (dtype == 1)
      layer_norm_bwd_bf16<TPR, VPL><<<grid, BLOCK, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(g), gf, mf, rf,
          static_cast<__nv_bfloat16*>(dx), rows, D);
    else
      layer_norm_bwd_f32<TPR, VPL><<<grid, BLOCK, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g), gf, mf,
          rf, static_cast<float*>(dx), rows, D);
    return cudaGetLastError();
  });
}
