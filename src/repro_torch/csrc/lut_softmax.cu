// Row softmax through the paper's LUT pipeline (§VI, eqs 10-12), for sm_90a.
//
// Replaces the TPU kernel `lut_softmax_2d` of the reference
// (src/repro/kernels/lut_softmax.py: bodies `_softmax_kernel_fixed`,
// `_softmax_kernel_float`, `_reciprocal_q24_body`).
//
// What it computes, per row of a [M, N] float32 array:
//   z_i  = clip(max_j x_j - x_i, 0, 10)
//   fixed: z_q = rint(z_i * 2^24); num_i = EXP_Q24[clip(z_q >> 19, 0, 319)]
//          s   = sum_i ((num_i + 2^(pre-1)) >> pre)          (int32)
//          inv = reciprocal_q24(s) >> pre   (ilog2 ladder, mantissa to [1,2),
//                                            INV_Q24 lookup, saturating shift)
//          y_i = fixed_mul(num_i, inv) * 2^-24   (12/12-bit limbs, int32)
//   float: num_i = EXP_F32[clip(int(z_i * 32), 0, 319)]; y_i = num_i / sum num
// The pre-shift is the ROUNDING form of `core/approx.py::_pre_shift`, not the
// truncating `num >> pre` of the TPU kernel body: the two agree at pre == 0
// (N <= 64) and the rounding form is the oracle's.
//
// What bounds it here: bytes.  A row is 27 to 99 floats on the KWT path and
// the arithmetic is a few dozen integer ops per element, so the kernel is
// bound by reading x and writing y (and, at small M, by the launch itself).
// Design: one warp owns a row, so the row max and the row sum are warp
// shuffles and never touch shared or device memory; the int32 sum is
// order-independent, which is what lets the result equal the plain version
// to the bit.  The two 320-entry tables are staged in shared memory once per
// block, and a block's warps walk over many rows (grid-stride), so short rows
// do not pay one table load per row.  Nothing of the TPU kernel's (8, 128)
// row-slab tiling is carried over; any M >= 1 and N >= 1 is handled by the
// strided lane loop.  The float variant sums in float64: the table entries
// are multiples of 2^-38 not above 1, so a float64 sum of up to 2^14 of them
// is exact in any order, and the kernel equals its plain version bit for bit
// there too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEntries = 320;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float row_max(const float* xr, int n, int lane) {
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, xr[i]);
  return warp_max(mx);
}

// z = clip(max - x, 0, 10): one float32 subtract, then the clamp.
__device__ __forceinline__ float clipped_distance(float mx, float x) {
  return fminf(fmaxf(__fsub_rn(mx, x), 0.0f), 10.0f);
}

// floor(log2(x)) for positive int32, the same compare ladder as
// core/fixedpoint.py::ilog2 (0 for x <= 1).
__device__ __forceinline__ int ilog2_ladder(int x) {
  int k = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    if (x >= (1 << step)) {
      k += step;
      x >>= step;
    }
  }
  return k;
}

// core/lut.py::reciprocal_q24 with range reduction.
__device__ __forceinline__ int reciprocal_q24(int s, const int* inv_tab) {
  const int t = ilog2_ladder(s) - 24;
  const int tp = t > 0 ? t : 0;
  const int tn = t < 0 ? -t : 0;
  const int m = (s >> tp) << tn;  // mantissa in [1, 2), Q8.24
  int idx = (m >> 19) - 1;
  idx = idx < 0 ? 0 : (idx > kEntries - 1 ? kEntries - 1 : idx);
  const int inv_m = inv_tab[idx];
  if (t >= 0) return inv_m >> tp;
  // saturating left shift: compare against INT32_MAX >> tn BEFORE shifting
  const int limit = 0x7fffffff >> tn;
  return inv_m > limit ? 0x7fffffff : (inv_m << tn);
}

// core/fixedpoint.py::fixed_mul(nonneg=True): (a * b) >> 24 in 12/12 limbs.
__device__ __forceinline__ int fixed_mul_nonneg(int a, int b) {
  const int ah = a >> 12, al = a & 0xFFF;
  const int bh = b >> 12, bl = b & 0xFFF;
  return ah * bh + ((ah * bl + al * bh) >> 12) + ((al * bl) >> 24);
}

__device__ __forceinline__ int exp_q24(const int* exp_tab, float mx, float x) {
  const float z = clipped_distance(mx, x);
  const int z_q = __float2int_rn(__fmul_rn(z, 16777216.0f));  // ALU_TO_FIXED
  int idx = z_q >> 19;
  idx = idx < 0 ? 0 : (idx > kEntries - 1 ? kEntries - 1 : idx);
  return exp_tab[idx];                                         // ALU_EXP
}

__global__ void __launch_bounds__(kThreads)
softmax_fixed_kernel(const float* __restrict__ x, const int* __restrict__ exp_g,
                     const int* __restrict__ inv_g, float* __restrict__ out,
                     int m, int n, int pre) {
  __shared__ int exp_tab[kEntries];
  __shared__ int inv_tab[kEntries];
  for (int i = threadIdx.x; i < kEntries; i += kThreads) {
    exp_tab[i] = exp_g[i];
    inv_tab[i] = inv_g[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = pre > 0 ? (1 << (pre - 1)) : 0;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < m;
       row += (long long)gridDim.x * kWarps) {
    const float* xr = x + row * n;
    float* yr = out + row * n;
    const float mx = row_max(xr, n, lane);
    int s = 0;
    for (int i = lane; i < n; i += 32)
      s += (exp_q24(exp_tab, mx, xr[i]) + half) >> pre;
    s = warp_sum(s);
    const int inv = reciprocal_q24(s, inv_tab) >> pre;           // ALU_INVERT
    for (int i = lane; i < n; i += 32) {
      const int y = fixed_mul_nonneg(exp_q24(exp_tab, mx, xr[i]), inv);
      yr[i] = __fmul_rn(__int2float_rn(y), 5.9604644775390625e-08f);  // 2^-24
    }
  }
}

__device__ __forceinline__ float exp_f32(const float* exp_tab, float mx, float x) {
  const float z = clipped_distance(mx, x);
  int idx = (int)__fmul_rn(z, 32.0f);  // truncation toward zero, not rounding
  idx = idx < 0 ? 0 : (idx > kEntries - 1 ? kEntries - 1 : idx);
  return exp_tab[idx];
}

__global__ void __launch_bounds__(kThreads)
softmax_float_kernel(const float* __restrict__ x, const float* __restrict__ exp_g,
                     float* __restrict__ out, int m, int n) {
  __shared__ float exp_tab[kEntries];
  for (int i = threadIdx.x; i < kEntries; i += kThreads) exp_tab[i] = exp_g[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < m;
       row += (long long)gridDim.x * kWarps) {
    const float* xr = x + row * n;
    float* yr = out + row * n;
    const float mx = row_max(xr, n, lane);
    double s = 0.0;
    for (int i = lane; i < n; i += 32) s += (double)exp_f32(exp_tab, mx, xr[i]);
    const float total = (float)warp_sum(s);
    for (int i = lane; i < n; i += 32)
      yr[i] = __fdiv_rn(exp_f32(exp_tab, mx, xr[i]), total);
  }
}

inline int blocks_for(int m) {
  const int b = (m + kWarps - 1) / kWarps;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

extern "C" int lut_softmax_fixed_launch(const float* x, const int* exp_tab,
                                        const int* inv_tab, float* out, int m,
                                        int n, int pre, cudaStream_t stream) {
  softmax_fixed_kernel<<<blocks_for(m), kThreads, 0, stream>>>(
      x, exp_tab, inv_tab, out, m, n, pre);
  return (int)cudaGetLastError();
}

extern "C" int lut_softmax_float_launch(const float* x, const float* exp_tab,
                                        float* out, int m, int n,
                                        cudaStream_t stream) {
  softmax_float_kernel<<<blocks_for(m), kThreads, 0, stream>>>(x, exp_tab, out,
                                                               m, n);
  return (int)cudaGetLastError();
}
