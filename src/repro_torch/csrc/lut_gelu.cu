// Piecewise LUT GELU (paper §VI, eq 13, Fig 7, ALU_GELU), for sm_90a.
//
// Replaces the TPU kernel `lut_gelu_2d` of the reference
// (src/repro/kernels/lut_gelu.py, body `_gelu_kernel`).
//
// What it computes, per element (float32 arithmetic; bf16 data is widened on
// load and rounded to nearest-even on store):
//   t   = (x - lo) * scale            lo = f32(-1.857), scale = f32(31/3.452)
//   mid = GELU_F32[clip(rint(t), 0, 31)]                          (nearest)
//       | tab[i0]*(1-frac) + tab[i0+1]*frac,  i0 = floor(clip(t, 0, 31))
//                                                                 (interp)
//   y   = x if x > hi, 0 if x < lo, else mid        hi = f32(1.595)
// lo, hi and scale are rounded to float32 on the host and handed in, so the
// kernel subtracts and multiplies the very operands the plain version does.
//
// What bounds it here: bytes — one read and one write per element against a
// handful of float ops.  Design: a flat 1-D grid-stride loop over the
// elements (no (8, 128) tile padding, no 2-D block geometry: the function is
// elementwise and the array is contiguous), the 32-entry table in shared
// memory.  Every float op that a compiler could contract into an FMA is
// written with the round-to-nearest intrinsics: the interp blend
// a*(1-f) + b*f would otherwise fuse and differ from the plain version in
// the last bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTable = 32;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_kernel(const T* __restrict__ x, const float* __restrict__ tab_g,
            T* __restrict__ out, long long numel, int interp, float lo,
            float hi, float scale) {
  __shared__ float tab[kTable];
  if (threadIdx.x < kTable) tab[threadIdx.x] = tab_g[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < numel;
       i += stride) {
    const float v = load_f32(x, i);
    const float t = __fmul_rn(__fsub_rn(v, lo), scale);
    float mid;
    if (!interp) {
      int idx = __float2int_rn(t);  // round half to even, saturating
      idx = idx < 0 ? 0 : (idx > kTable - 1 ? kTable - 1 : idx);
      mid = tab[idx];
    } else {
      const float tc = fminf(fmaxf(t, 0.0f), (float)(kTable - 1));
      int i0 = (int)floorf(tc);
      i0 = i0 < 0 ? 0 : (i0 > kTable - 2 ? kTable - 2 : i0);
      const float frac = __fsub_rn(tc, (float)i0);
      mid = __fadd_rn(__fmul_rn(tab[i0], __fsub_rn(1.0f, frac)),
                      __fmul_rn(tab[i0 + 1], frac));
    }
    const float y = v > hi ? v : (v < lo ? 0.0f : mid);
    store_f32(out, i, y);
  }
}

}  // namespace

extern "C" int lut_gelu_launch(const void* x, const float* tab, void* out,
                               long long numel, int interp, int is_bf16,
                               float lo, float hi, float scale,
                               cudaStream_t stream) {
  long long want = (numel + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (is_bf16) {
    gelu_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)x, tab, (__nv_bfloat16*)out, numel, interp, lo,
        hi, scale);
  } else {
    gelu_kernel<float><<<blocks, kThreads, 0, stream>>>(
        (const float*)x, tab, (float*)out, numel, interp, lo, hi, scale);
  }
  return (int)cudaGetLastError();
}
