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
// lo, hi and scale are the double expressions of core/lut.py (GELU_LO,
// GELU_HI, (N_GELU_ENTRIES - 1) / (GELU_HI - GELU_LO)) rounded once to
// float32, as core/approx.py::gelu_lut rounds them, so the kernel subtracts
// and multiplies the very operands the plain version does.
// Every float op that a compiler could contract into an FMA is written with
// the round-to-nearest intrinsics: the interp blend a*(1-f) + b*f would
// otherwise fuse and differ from the plain version in the last bit.
//
// What bounds it here: bytes — one read and one write per element against a
// handful of float ops.  A first kernel made one 4-byte (bf16: 2-byte) load
// per thread per step of a grid-stride loop over at most 8192 blocks, too
// few bytes in flight per SM to cover the latency of device memory: 80 % of
// the bound at [405504, 256].
//
// This design:
//   - 16-byte accesses: a float4 of f32, or 8 bf16 through a uint4.
//   - Each thread loads kUnroll = 2 vectors before it uses any: 32 bytes in
//     flight per thread, 64 KB per SM at 2048 threads.
//   - One block per 256 x kUnroll vectors, launched in order, so the blocks
//     in flight stream one compact stretch of the array.  (A persistent grid,
//     SM count x 8 blocks walking the array with a grid stride, measured
//     slower on the H100; 1, 2 and 4 vectors a thread measured alike.)
//   - The launcher cuts the flat array into a scalar head up to the first
//     16-byte boundary (the whole array where it ends before one), whole
//     vectors, and a scalar tail of fewer than one vector; the first threads
//     of the grid do head and tail.  The output is allocated with the
//     input's offset modulo 16 bytes (`empty_aligned_like` in
//     kernels/lut_gelu.py), so one cut serves both; where there are whole
//     vectors, the launcher refuses operands whose offsets differ.
//   - The 32-entry table sits in shared memory: 32 words on 32 banks, so a
//     warp's lookups never conflict.  Holding it one entry a lane and
//     looking up with __shfl_sync would need every lane converged at each
//     lookup, which the ragged head, tail and last block are not; the
//     shared-memory lookup costs the same one instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "launch_geometry.cuh"

namespace {

constexpr int kTable = 32;
constexpr float kLo = static_cast<float>(-1.857);
constexpr float kHi = static_cast<float>(1.595);
constexpr float kScale = static_cast<float>(31.0 / (1.595 - -1.857));
constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte vectors a thread loads before it uses any

template <bool kInterp>
__device__ __forceinline__ float gelu_lut(float v, const float* tab) {
  const float t = __fmul_rn(__fsub_rn(v, kLo), kScale);
  float mid;
  if constexpr (!kInterp) {
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
  return v > kHi ? v : (v < kLo ? 0.0f : mid);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kInterp>
__device__ __forceinline__ T gelu_one(T v, const float* tab) {
  return from_f32<T>(gelu_lut<kInterp>(to_f32(v), tab));
}

// One 16-byte vector: kN elements of T, applied one by one.
template <typename T>
struct Vector {
  static constexpr int kN = 16 / sizeof(T);
  template <bool kInterp>
  __device__ __forceinline__ static uint4 apply(uint4 raw, const float* tab) {
    T e[kN];
    memcpy(e, &raw, 16);
#pragma unroll
    for (int k = 0; k < kN; ++k) e[k] = gelu_one<T, kInterp>(e[k], tab);
    memcpy(&raw, e, 16);
    return raw;
  }
};

template <typename T, bool kInterp>
__global__ void __launch_bounds__(kThreads)
gelu_kernel(const T* __restrict__ x, const float* __restrict__ tab_g,
            T* __restrict__ out, long long numel, long long head,
            long long vectors) {
  __shared__ float tab[kTable];
  if (threadIdx.x < kTable) tab[threadIdx.x] = tab_g[threadIdx.x];
  __syncthreads();
  constexpr int kN = Vector<T>::kN;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long tail = head + vectors * kN;
  if (t < head) out[t] = gelu_one<T, kInterp>(x[t], tab);
  if (t < numel - tail) out[tail + t] = gelu_one<T, kInterp>(x[tail + t], tab);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  const long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < vectors) v[u] = xv[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < vectors) ov[i] = Vector<T>::template apply<kInterp>(v[u], tab);
  }
}

// The cut of the flat array: a scalar head up to x's first 16-byte
// boundary (all of an array that ends before it), whole vectors, a scalar
// tail.  The vectors of out are cut at the same elements, so where there
// are any, out must have x's offset modulo 16 bytes.
template <typename T, bool kInterp>
int launch(const void* x, const float* tab, void* out, long long numel,
           cudaStream_t stream, LaunchGeo* geo) {
  constexpr int kN = Vector<T>::kN;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if ((xa | oa) % sizeof(T) != 0) return (int)cudaErrorInvalidValue;
  long long head = (long long)(((16 - (xa & 15)) & 15) / sizeof(T));
  if (head > numel) head = numel;
  const long long vectors = (numel - head) / kN;
  if (vectors > 0 && ((xa ^ oa) & 15) != 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kUnroll;
  const long long want = (vectors + per_block - 1) / per_block;
  if (want >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = want < 1 ? 1 : (int)want;
  if (geo) return put_geo({blocks, kThreads, 0, head}, geo);
  gelu_kernel<T, kInterp><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), tab, static_cast<T*>(out), numel, head,
      vectors);
  return (int)cudaGetLastError();
}

int run(const void* x, const float* tab, void* out, long long numel, int mode,
        cudaStream_t stream, LaunchGeo* geo) {
  switch (mode) {
    case 0: return launch<float, false>(x, tab, out, numel, stream, geo);
    case 1: return launch<float, true>(x, tab, out, numel, stream, geo);
    case 2: return launch<__nv_bfloat16, false>(x, tab, out, numel, stream, geo);
    case 3: return launch<__nv_bfloat16, true>(x, tab, out, numel, stream, geo);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 2 * (bfloat16 data) + (interp)
extern "C" int lut_gelu_launch(const void* x, const float* tab, void* out,
                               long long numel, int mode, cudaStream_t stream) {
  return run(x, tab, out, numel, mode, stream, nullptr);
}

// The launcher's geometry for the same arguments (the addresses only for
// their alignment): out4 = grid, threads, dynamic shared memory, and the
// scalar head (elements before the first 16-byte vector).  Launches
// nothing.
extern "C" int lut_gelu_geometry(const void* x, void* out, long long numel,
                                 int mode, long long* out4) {
  return run(x, nullptr, out, numel, mode, nullptr,
             reinterpret_cast<LaunchGeo*>(out4));
}
